"""Core library: the exhaustive Tanimoto KNN engines in PyTorch."""
from .fingerprints import (  # noqa: F401
    pack_bits, unpack_bits, popcount, tanimoto, tanimoto_scores,
    batched_tanimoto_scores, n_words, DEFAULT_LEN,
    Metric, TANIMOTO, resolve_metric, METRIC_NAMES,
    metric_scores, batched_metric_scores,
)
from .engine import (  # noqa: F401
    SearchEngine, BruteForceEngine, BitBoundFoldingEngine, recall_at_k,
)
from . import bitbound, folding, topk  # noqa: F401
