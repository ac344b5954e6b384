from .molecules import synthetic_fingerprints, SyntheticConfig  # noqa: F401
