"""Wrappers around the CUDA kernels (padding, tiling and window policy).

Each wrapper takes int32 bit-view tensors. On a CUDA tensor it launches its
kernel from ``csrc/tanimoto_topk.cu`` (built by ``_build`` on first use),
checks the C function's error code and raises if it is not 0; there is no
fallback. On a CPU tensor, and only then, it runs the kernel's plain
version from ``ref.py``. Each wrapper counts its launches in
``<wrapper>.launches``; :func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

import torch

from ..core.fingerprints import Metric, TANIMOTO, as_words, popcount
from . import ref

DEFAULT_TILE_N = 2048
_METRIC_IDS = {"tanimoto": 0, "dice": 1, "cosine": 2, "tversky": 3}
#: largest k a kernel block can select (its key buffer holds k + 1024 keys,
#: padded to a power of two, in at most 64 KiB of shared memory)
MAX_K = 7168


def _pick_tile(n: int, tile_n: int | None) -> int:
    """The reference's tile policy: at most 2048 rows, at least 128, the
    largest power of two below ``n``."""
    if tile_n is not None:
        return tile_n
    return min(DEFAULT_TILE_N, max(128, 1 << (max(n - 1, 1)).bit_length() - 1))


def reset_launch_counts() -> None:
    tanimoto_topk.launches = 0
    window_topk.launches = 0


def launch_counts() -> dict:
    return {"tanimoto_topk": tanimoto_topk.launches,
            "window_topk": window_topk.launches}


def _splits(q_n: int, rows: int, device: torch.device) -> int:
    """Row splits per query for pass 1: enough blocks for ~8 per SM, with
    at least one 1024-row step per split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-8 * sms // max(q_n, 1))
    return int(max(1, min(want, -(-max(rows, 1) // 1024), 65535)))


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(fn_name, queries, db, db_cnt, k, metric, bounds=()):
    q_n, w = queries.shape
    n = db.shape[0]
    if db.shape[1] != w:
        raise ValueError(f"{fn_name}: query width {w} != db width {db.shape[1]}")
    if db_cnt.shape != (n,):
        raise ValueError(f"{fn_name}: db_cnt must have shape ({n},)")
    if not 0 < k <= MAX_K:
        raise ValueError(f"{fn_name}: k={k} outside 1..{MAX_K}")
    if q_n >= 2**31 or n >= 2**31:
        raise ValueError(f"{fn_name}: too many queries or rows")
    from . import _build
    dev = db.device
    splits = _splits(q_n, n, dev)
    scratch = torch.empty((q_n, splits, k), dtype=torch.int64, device=dev)
    ids = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    vals = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    pa, pb = metric.tversky_weights
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), fn_name)(
            queries.data_ptr(), db.data_ptr(), db_cnt.data_ptr(),
            *(b.data_ptr() for b in bounds), q_n, n, w, k,
            _METRIC_IDS[metric.name], pa, pb, splits, scratch.data_ptr(),
            ids.data_ptr(), vals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
    return ids, vals


def tanimoto_topk(queries: torch.Tensor, db: torch.Tensor, k: int,
                  db_popcount: torch.Tensor | None = None,
                  tile_n: int | None = None, metric: Metric | None = None):
    """Fused exhaustive KNN: (Q, W) x (N, W) -> ids (Q, k) i32, scores
    (Q, k) f32, by (score desc, row asc); empty slots are -1 / -inf.

    ``tile_n`` is accepted for the reference's signature: the scan masks
    nothing but rows past ``N``, so the result does not depend on it."""
    metric = metric if metric is not None else TANIMOTO
    queries, db = as_words(queries), as_words(db)
    if db_popcount is None:
        db_popcount = popcount(db)
    db_popcount = db_popcount.to(device=db.device, dtype=torch.int32)
    if db.device.type == "cpu":
        return ref.tanimoto_topk_ref(queries, db, k, db_popcount, metric=metric)
    queries, db, db_popcount = (t.contiguous() for t in (queries, db, db_popcount))
    _check_cuda("tanimoto_topk", queries, db, db_popcount)
    out = _launch("tanimoto_topk_cuda", queries, db, db_popcount, k, metric)
    tanimoto_topk.launches += 1
    return out


def window_bounds(lo_row, hi_row, n: int, max_tiles: int | None = None,
                  tile_n: int | None = None, device=None):
    """The rows ``window_topk`` scans per query, as int32 ``[lo, hi)``:
    the window ``[lo_row, hi_row)`` cut to its first ``max_tiles`` tiles of
    ``_pick_tile(n, tile_n)`` rows from tile ``lo_row // tile`` — the
    reference's grid semantics, truncation included."""
    tile = _pick_tile(n, tile_n)
    total_tiles = -(-n // tile)
    if max_tiles is None:
        max_tiles = total_tiles
    max_tiles = max(min(int(max_tiles), total_tiles), 1)
    lo = torch.as_tensor(lo_row, device=device).to(torch.int32)
    hi = torch.as_tensor(hi_row, device=device).to(torch.int32)
    lo_tile = torch.div(lo, tile, rounding_mode="floor")
    n_tiles = torch.where(
        hi > lo, torch.div(hi + tile - 1, tile, rounding_mode="floor") - lo_tile,
        0).clamp(0, max_tiles)
    return lo, torch.minimum(hi, (lo_tile + n_tiles) * tile)


def window_topk(queries: torch.Tensor, db: torch.Tensor, db_cnt: torch.Tensor,
                lo_row: torch.Tensor, hi_row: torch.Tensor, k: int,
                max_tiles: int | None = None, tile_n: int | None = None,
                metric: Metric | None = None):
    """Fused KNN over a per-query row window [lo_row, hi_row) of ``db``.

    Stage 1 of the two-stage engine: ``db`` is typically the folded,
    popcount-sorted database while the row bounds come from the Eq.2 window
    on the full-resolution popcounts. Ids index into ``db``; empty slots
    are id -1 / score -inf.

    ``max_tiles`` keeps the reference's semantics exactly: a window is
    scanned from tile ``lo_row // tile`` for at most ``max_tiles`` tiles,
    and a window spanning more tiles is silently truncated, its rows beyond
    never scored, with no error and no marker. The engine sizes
    ``max_tiles`` as a power of two at or above the batch's largest window
    (``bitbound.bucket_tiles``); other callers must size it the same way.
    """
    metric = metric if metric is not None else TANIMOTO
    queries, db = as_words(queries), as_words(db)
    dev = db.device
    lo, hi = window_bounds(lo_row, hi_row, db.shape[0], max_tiles, tile_n, dev)
    cnt = torch.as_tensor(db_cnt, device=dev).to(torch.int32)
    if dev.type == "cpu":
        return ref.window_topk_ref(queries, db, cnt, lo, hi, k, metric=metric)
    queries, db, cnt, lo, hi = (t.contiguous() for t in (queries, db, cnt, lo, hi))
    _check_cuda("window_topk", queries, db, cnt, lo, hi)
    out = _launch("window_topk_cuda", queries, db, cnt, k, metric, (lo, hi))
    window_topk.launches += 1
    return out


reset_launch_counts()
