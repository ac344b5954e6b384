"""BitBound pruning (Swamidass & Baldi) — Eq. 2 of the paper.

The database is sorted by popcount once at build time. For a query with
popcount ``a`` and similarity cutoff ``Sc``, only candidates whose popcount
``b`` satisfies ``a * Sc <= b <= a / Sc`` (Eq. 2; other metrics via
``Metric.bound_ratios``) can reach the cutoff, and in the popcount-sorted
database they form one contiguous row range, found with two searchsorteds.

The windows are computed on the host in float64, exactly as the reference
computes them, boundary cases included: a row whose f32 score rounds to the
cutoff can fall just outside the window, and the port keeps that.
"""
from __future__ import annotations

import numpy as np

from .fingerprints import Metric, TANIMOTO


def bound_counts_np(query_counts: np.ndarray, cutoff: float,
                    metric: Metric = TANIMOTO):
    """Per-metric popcount bounds in float64 (Tanimoto: Eq. 2
    ``[ceil(a*Sc), floor(a/Sc)]``). The one host-side bound formula: the
    main-segment windows and the delta masks both call it, so they agree
    on every boundary popcount. Unbounded sides come back as 0 / +inf."""
    a = np.asarray(query_counts, dtype=np.float64)
    if metric.name == "tanimoto":
        lo_cnt = np.ceil(a * cutoff)
        hi_cnt = np.floor(a / max(cutoff, 1e-6))
        return lo_cnt, hi_cnt
    lo_r, hi_r = metric.bound_ratios(cutoff)
    lo_cnt = np.ceil(a * lo_r) if metric.bounded_below else np.zeros_like(a)
    hi_cnt = (np.floor(a * hi_r) if metric.bounded_above
              else np.full_like(a, np.inf))
    return lo_cnt, hi_cnt


def bound_range_np(counts_sorted: np.ndarray, query_counts: np.ndarray,
                   cutoff: float, metric: Metric = TANIMOTO):
    """Batched per-metric windows [lo, hi) over a popcount-sorted database."""
    lo_cnt, hi_cnt = bound_counts_np(query_counts, cutoff, metric)
    lo = np.searchsorted(counts_sorted, lo_cnt, side="left")
    hi = np.searchsorted(counts_sorted, hi_cnt, side="right")
    return lo.astype(np.int64), hi.astype(np.int64)


def bucket_tiles(n_tiles: int, total_tiles: int) -> int:
    """Round a tile-window size up to the next power of two (clamped to the
    whole DB). The window kernel's ``max_tiles`` is this bucket, so every
    window of the batch is covered."""
    n_tiles = max(int(n_tiles), 1)
    b = 1 << (n_tiles - 1).bit_length()
    return min(b, max(int(total_tiles), 1))
