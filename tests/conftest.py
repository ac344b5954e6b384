import numpy as np
import pytest


@pytest.fixture(scope="session")
def small_db():
    from repro.data.molecules import SyntheticConfig, synthetic_fingerprints
    return synthetic_fingerprints(SyntheticConfig(n=2000, seed=0))


@pytest.fixture(scope="session")
def queries(small_db):
    from repro.data.molecules import queries_from_db
    return queries_from_db(small_db, 16)


@pytest.fixture(scope="session")
def brute_truth(small_db, queries):
    """Oracle top-20 ids for the shared query set."""
    import jax.numpy as jnp
    from repro.core import batched_tanimoto_scores
    s = np.asarray(batched_tanimoto_scores(jnp.asarray(queries), jnp.asarray(small_db)))
    ids = np.argsort(-s, axis=1, kind="stable")[:, :20]
    return s, ids


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch sees none")
