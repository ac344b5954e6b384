"""Top-k primitives with the reference's tie rules.

* :func:`merge_sorted` — rank-computation merge of two descending runs,
  keeping the best ``len(run A)``; ties place run A first.
* :func:`streaming_topk` — running top-k over a score stream, tile by tile;
  ties keep the lowest index first.

``torch.topk`` documents no order for ties, so every selection here is a
stable descending sort followed by a slice.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def stable_topk(scores: torch.Tensor, k: int):
    """Top-``k`` along the last axis, ties to the lowest index:
    ``(values, indices)``, both sorted by (score desc, index asc)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_sorted(s_a: torch.Tensor, i_a: torch.Tensor,
                 s_b: torch.Tensor, i_b: torch.Tensor):
    """Merge two descending-sorted runs (last axis; leading axes batch),
    keeping the best ``s_a.shape[-1]``. Each element's output position is
    its own index plus the count of the other run's elements strictly ahead
    of it; ties place run-A elements first."""
    a, b = s_a.shape[-1], s_b.shape[-1]
    na, nb = (-s_a).contiguous(), (-s_b).contiguous()   # ascending views
    ar_a = torch.arange(a, device=s_a.device)
    ar_b = torch.arange(b, device=s_b.device)
    pos_a = ar_a + torch.searchsorted(nb, na, side="left")
    pos_b = ar_b + torch.searchsorted(na, nb, side="right")
    shape = (*s_a.shape[:-1], a + b)
    out_s = torch.zeros(shape, dtype=s_a.dtype, device=s_a.device)
    out_i = torch.zeros(shape, dtype=i_a.dtype, device=i_a.device)
    out_s.scatter_(-1, pos_a, s_a).scatter_(-1, pos_b, s_b)
    out_i.scatter_(-1, pos_a, i_a).scatter_(-1, pos_b, i_b.to(i_a.dtype))
    return out_s[..., :a], out_i[..., :a]


def streaming_topk(scores: torch.Tensor, k: int, tile: int = 2048):
    """Running top-k over a score stream (N,), tiled like the engine.

    Returns (values desc, indices). Pads N up to a tile multiple with -inf;
    empty slots hold -inf / -1."""
    n = scores.shape[0]
    pad = (-n) % tile
    scores_p = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    run_s = torch.full((k,), NEG_INF, dtype=scores.dtype, device=scores.device)
    run_i = torch.full((k,), -1, dtype=torch.int32, device=scores.device)
    for t in range(scores_p.shape[0] // tile):
        tile_s = scores_p[t * tile:(t + 1) * tile]
        s_sorted, pos = stable_topk(tile_s, min(tile, k))
        i_sorted = (t * tile + pos).to(torch.int32)
        run_s, run_i = merge_sorted(run_s, run_i, s_sorted, i_sorted)
    return run_s, run_i
