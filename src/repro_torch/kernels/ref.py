"""Plain PyTorch versions of the kernels: the CPU path and the yardstick the
CUDA kernels are held against, bit for bit.

Top-k selection is a stable descending sort (ties to the lowest row), and
slots no row fills come back as id -1 / score -inf, also when ``k`` exceeds
the rows. Scores are computed a block of queries at a time, so memory stays
bounded at the full database size.
"""
from __future__ import annotations

import torch

from ..core.fingerprints import (Metric, TANIMOTO, batched_metric_scores,
                                 popcount)
from ..core.topk import stable_topk

#: largest (queries x rows) score block held at once
_BLOCK_ELEMS = 1 << 26


def tanimoto_scores_ref(queries: torch.Tensor, db: torch.Tensor,
                        db_popcount: torch.Tensor | None = None,
                        metric: Metric = TANIMOTO) -> torch.Tensor:
    """(Q, W) x (N, W) int32 words -> (Q, N) float32 score matrix."""
    if db_popcount is None:
        db_popcount = popcount(db)
    return batched_metric_scores(queries, db, metric, db_popcount)


def _masked_topk(queries, db, db_cnt, k, metric, lo=None, hi=None):
    q_n, n = queries.shape[0], db.shape[0]
    ids = torch.full((q_n, k), -1, dtype=torch.int32, device=db.device)
    vals = torch.full((q_n, k), float("-inf"), dtype=torch.float32,
                      device=db.device)
    if db_cnt is None:
        db_cnt = popcount(db)
    step = max(1, _BLOCK_ELEMS // max(n, 1))
    kk = min(k, n)
    for q0 in range(0, q_n, step):
        q1 = min(q0 + step, q_n)
        s = tanimoto_scores_ref(queries[q0:q1], db, db_cnt, metric=metric)
        if lo is not None:
            idx = torch.arange(n, device=db.device)[None, :]
            inside = (idx >= lo[q0:q1, None]) & (idx < hi[q0:q1, None])
            s = torch.where(inside, s, float("-inf"))
        v, i = stable_topk(s, kk)
        vals[q0:q1, :kk] = v
        ids[q0:q1, :kk] = torch.where(torch.isfinite(v), i.to(torch.int32), -1)
    return ids, vals


def tanimoto_topk_ref(queries: torch.Tensor, db: torch.Tensor, k: int,
                      db_popcount: torch.Tensor | None = None,
                      metric: Metric = TANIMOTO):
    """Plain version of the full-scan kernel: exact top-k (ids, scores)."""
    return _masked_topk(queries, db, db_popcount, k, metric)


def window_topk_ref(queries: torch.Tensor, db: torch.Tensor,
                    db_cnt: torch.Tensor, lo_row: torch.Tensor,
                    hi_row: torch.Tensor, k: int, metric: Metric = TANIMOTO):
    """Plain version of the row-window kernel: rows outside
    [lo_row[q], hi_row[q]) are never returned."""
    return _masked_topk(queries, db, db_cnt, k, metric,
                        lo_row.to(torch.int64), hi_row.to(torch.int64))
