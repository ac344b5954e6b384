"""The paper's own search config."""
from .paper import PaperSearchConfig, CHEMBL_LIKE  # noqa: F401
