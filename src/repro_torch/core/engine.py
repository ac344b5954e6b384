"""Exhaustive similarity-search engines (paper §IV) in PyTorch.

* :class:`BruteForceEngine` — exhaustive scan through the fused scan+top-k
  kernel (``kernels.ops.tanimoto_topk``).
* :class:`BitBoundFoldingEngine` — Eq.2 popcount pruning and two-stage
  modulo-OR folding: a host reference (``search_numpy``) and a
  device-resident path (``search_device``) whose stage 1 is the row-window
  kernel (``kernels.ops.window_topk``).

Every engine exposes ``search(queries, k) -> (ids, sims)`` numpy arrays and
runs the device path through ``kernels/ops.py`` on its ``device`` (default
``"cuda"``). On ``device="cuda"`` the hot stage launches the CUDA kernel; on
``device="cpu"`` the same path runs the kernel's plain version, only because
its tensors lie on the CPU.

:class:`BitBoundFoldingEngine` also has a host reference, selected with
``backend="numpy"`` (the parity oracle for the device path); its default,
``backend="cuda"``, is the device path. Invalid names raise ``ValueError``.

Online inserts go to a :class:`repro_torch.serve.store.MutableFingerprintStore`
(popcount-sorted or id-ordered main segment plus an append-only delta).
After any interleaving of inserts and searches, compactions included,
results are bit-identical to a from-scratch engine on the concatenated
database: ties keep the lowest row, and the main and delta runs merge with
the main run first.

Work accounting: ``scanned(n_queries)`` is the number of candidates scored
for ``n_queries`` queries, extrapolated from the most recent ``search``
batch; brute force computes it in closed form.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops as kops
from . import bitbound as bb
from . import folding as fl
from .fingerprints import (Metric, as_words, intersections, metric_from_counts,
                           metric_from_counts_np, popcount, resolve_metric,
                           words_np)
from .topk import merge_sorted, stable_topk

NEG_INF = float("-inf")


def _store_mod():
    # lazy: the serve package imports core back
    from ..serve import store
    return store


def _merge_main_delta(s_a, i_a, s_b, i_b, n_main: int):
    """Rank-merge the main-segment and delta (scores, ids) runs, keeping the
    best ``k = s_a.shape[1]`` per row; ties keep the main run ahead.
    Main-run entries pointing at capacity-pad rows (``id >= n_main``) are
    masked first, or their sim-0 entries would win ties against real sim-0
    delta rows."""
    pad = i_a >= n_main
    s_a = torch.where(pad, NEG_INF, s_a)
    i_a = torch.where(pad, -1, i_a)
    return merge_sorted(s_a, i_a, s_b, i_b)


class SearchEngine:
    """Shared plumbing: device selection, a cache of built pipelines, and
    the ``scanned`` work-counter contract."""

    def _init_engine(self, on_device: bool = True) -> None:
        self.device = torch.device(self.device)
        if (on_device and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"{type(self).__name__}: CUDA is not available; pass "
                f"device='cpu' to run the device path on the CPU")
        self._last_scanned = 0
        self._last_n_queries = 0
        self._pipelines: dict = {}
        self.stats: dict = {}

    def _resolve_metric_width(self, words: int) -> None:
        """Resolve the ``metric`` spec and pin the fingerprint width;
        an explicit ``fp_bits`` must match the packed word count."""
        self.metric = resolve_metric(self.metric)
        words = int(words)
        if self.fp_bits is None:
            self.fp_bits = words * 32
        elif int(self.fp_bits) != words * 32:
            raise ValueError(
                f"fp_bits={self.fp_bits} does not match the database width "
                f"({words} words = {words * 32} bits)")

    def _cached(self, key, builder):
        fn = self._pipelines.get(key)
        if fn is None:
            fn = builder()
            self._pipelines[key] = fn
        return fn

    def _record_batch(self, scanned, n_queries) -> None:
        self._last_scanned = int(scanned)
        self._last_n_queries = int(n_queries)

    def scanned(self, n_queries: int) -> int:
        """Candidates scored for ``n_queries`` queries, extrapolated from the
        most recent search batch (0 before any search)."""
        if self._last_n_queries == 0:
            return 0
        return round(self._last_scanned * n_queries / self._last_n_queries)

    def _queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return as_words(queries, self.device).contiguous()
        return as_words(np.asarray(queries, dtype=np.uint32), self.device)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A store array on the engine's device as int32 (words as
        bit-views; counts and ids fit)."""
        if arr.dtype == np.uint32:
            return as_words(arr, self.device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=torch.int32)

    @property
    def n_total(self) -> int:
        return self.store.n_total

    def search(self, queries, k: int):
        raise NotImplementedError

    def insert(self, fps) -> np.ndarray:
        """Append fingerprints online; returns their global ids. Mis-dtyped
        rows raise ``ValueError`` up front."""
        fps = _store_mod().validate_rows(fps)
        if fps.shape[0] == 0:
            return np.empty((0,), dtype=np.int64)
        return self.store.insert(fps)   # compaction handled by the store


@dataclass
class BruteForceEngine(SearchEngine):
    """Exhaustive scan: the fused scan+top-k kernel over the
    (capacity-padded, global-id-ordered) main segment and over the delta,
    rank-merged with capacity-pad entries masked, so results match a
    from-scratch scan exactly for ``k <= n_total``."""
    db: np.ndarray
    compact_threshold: int = 4096
    #: prebuilt store (e.g. from ``serve.state``); ``db`` is ignored when set
    store: object = None
    metric: Metric | str | None = None
    fp_bits: int | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._init_engine()
        if self.store is None:
            self.store = _store_mod().MutableFingerprintStore(
                np.asarray(self.db), sorted_main=False, fold_m=1,
                compact_threshold=self.compact_threshold)
        else:
            if self.store.sorted_main or self.store.fold_m != 1:
                raise ValueError("restored store layout does not match "
                                 "a brute-force engine")
            self.compact_threshold = self.store.compact_threshold
        self._resolve_metric_width(self.store.words)
        self.db = None
        self._sync_gen = None
        self._sync_delta = None
        self._delta_dev = None

    def _sync(self) -> None:
        st = self.store
        if self._sync_gen != st.generation:
            self._sync_gen = st.generation
            self.db = self._upload(st.main.db)              # (capacity, W)
            self.db_cnt = self._upload(st.main.counts)      # pad rows -> 0
        if self._sync_delta != st.delta_version:
            self._sync_delta = st.delta_version
            self._delta_dev = None if st.n_delta == 0 else (
                self._upload(st.delta_db), self._upload(st.delta_counts))

    def search(self, queries, k: int):
        self._sync()
        q = self._queries(queries)
        ids, vals = kops.tanimoto_topk(q, self.db, k, db_popcount=self.db_cnt,
                                       metric=self.metric)
        if self._delta_dev is not None:
            ddb, dcnt = self._delta_dev
            dids, dvals = kops.tanimoto_topk(q, ddb, k, db_popcount=dcnt,
                                             metric=self.metric)
            n_main = self.store.n_main
            gids = torch.where(dids >= 0, dids + n_main, -1)
            vals, ids = _merge_main_delta(vals, ids, dvals, gids, n_main)
        return ids.cpu().numpy(), vals.cpu().numpy()

    def scanned(self, n_queries: int) -> int:
        # per-query work is the whole DB regardless of the query batch
        return n_queries * self.store.n_total


@dataclass
class BitBoundFoldingEngine(SearchEngine):
    """BitBound (Eq. 2) + 2-stage folding (paper §III-B, §IV-A).

    Stage 1 scans only the popcount-bounded range of the *folded* DB and
    keeps ``k_r1 = k*m*log2(2m)`` candidates; stage 2 rescores them at full
    resolution. ``m=1`` disables folding (pure BitBound).

    * ``search_numpy`` — host reference with true variable-length windows.
    * ``search_device`` — fixed-shape device path: the row-window kernel over
      each query's Eq.2 window of the folded main segment, a masked scan of
      the folded delta, the merge of both candidate sets in the order a
      from-scratch rebuild would sort them, and the full-resolution rescore
      with a stable top-k. Returns ``(ids, sims, scanned)`` tensors.

    ``backend`` selects what :meth:`search` runs: ``"cuda"`` (default, the
    device path on ``device``) or ``"numpy"`` (the host reference).
    """
    db: np.ndarray
    cutoff: float = 0.8
    m: int = 4
    scheme: int = 1
    backend: str = "cuda"
    compact_threshold: int = 4096
    store: object = None
    metric: Metric | str | None = None
    fp_bits: int | None = None
    device: str | torch.device = "cuda"

    BACKENDS = ("cuda", "numpy")

    def __post_init__(self):
        if self.backend not in self.BACKENDS:
            raise ValueError(
                f"{type(self).__name__} backend must be one of "
                f"{'/'.join(repr(b) for b in self.BACKENDS)}, "
                f"got {self.backend!r}")
        self._init_engine(on_device=self.backend == "cuda")
        if self.store is None:
            self.store = _store_mod().MutableFingerprintStore(
                np.asarray(self.db), sorted_main=True, fold_m=self.m,
                fold_scheme=self.scheme,
                compact_threshold=self.compact_threshold)
        else:
            if (not self.store.sorted_main or self.store.fold_m != self.m
                    or self.store.fold_scheme != self.scheme):
                raise ValueError("restored store layout does not match "
                                 "engine fold config")
            self.compact_threshold = self.store.compact_threshold
        self._resolve_metric_width(self.store.words)
        self.db = None
        self._sync_gen = None
        self._sync_delta = None
        self._delta_dev = None
        self._device_state: dict | None = None

    def _sync(self) -> None:
        """Upload the store's segments to the device when they changed."""
        st = self.store
        if self._sync_gen != st.generation:
            self._sync_gen = st.generation
            self.full = self._upload(st.main.db)
            self.full_cnt = self._upload(st.main.counts)    # pads PAD_COUNT
            self.folded = (self.full if st.main.folded is st.main.db
                           else self._upload(st.main.folded))
            self.folded_cnt = self._upload(st.main.folded_counts)
            self.order = self._upload(st.main.order)        # pads -1
        if self._sync_delta != st.delta_version:
            self._sync_delta = st.delta_version
            nd = st.n_delta
            if nd == 0:
                self._delta_dev = None
            else:
                sm = _store_mod()
                bucket = sm.next_pow2(nd)
                pad = bucket - nd
                wf = st.delta_folded.shape[1]
                d_cnt = np.concatenate(
                    [st.delta_counts, np.full((pad,), sm.PAD_COUNT, np.int64)])
                self._delta_dev = {
                    "bucket": bucket,
                    "full": self._upload(np.concatenate(
                        [st.delta_db, np.zeros((pad, st.words), np.uint32)])),
                    "folded": self._upload(np.concatenate(
                        [st.delta_folded, np.zeros((pad, wf), np.uint32)])),
                    "cnt": self._upload(d_cnt),
                    "folded_cnt": self._upload(np.concatenate(
                        [st.delta_folded_counts, np.zeros((pad,), np.int64)])),
                }

    # -- dispatch -----------------------------------------------------------
    def search(self, queries, k: int):
        """Top-k per query via the configured backend -> (ids, sims) numpy."""
        if self.backend == "cuda":
            ids, sims, _ = self.search_device(queries, k)
            return ids.cpu().numpy(), sims.cpu().numpy()
        return self.search_numpy(queries, k)

    # -- host-side (variable-shape) reference path --------------------------
    def _np_scores(self, q: np.ndarray, db: np.ndarray, db_cnt: np.ndarray):
        # tanimoto keeps the reference's f64 scorer; other metrics score in
        # f32 via the shared oracle
        inter = np.bitwise_count(q[None, :] & db).sum(-1).astype(np.int64)
        if self.metric.name == "tanimoto":
            union = (int(np.bitwise_count(q).sum())
                     + db_cnt.astype(np.int64) - inter)
            return np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        return metric_from_counts_np(self.metric, inter,
                                     int(np.bitwise_count(q).sum()),
                                     db_cnt.astype(np.int64))

    def search_numpy(self, queries, k: int):
        """Reference engine (numpy): true variable-range pruning, the parity
        oracle for :meth:`search_device`. The per-query window is the main
        segment's Eq.2 range plus the delta rows inside the same bounds,
        stably re-sorted by popcount (main first on ties)."""
        st = self.store
        if isinstance(queries, torch.Tensor):
            queries = words_np(queries)
        queries = np.asarray(queries, dtype=np.uint32)
        n_main_v = st.n_main
        full = st.main.db
        full_cnt = st.main.counts
        folded = st.main.folded
        folded_cnt = st.main.folded_counts
        order = st.main.order
        kr1 = fl.kr1_for(k, self.m)
        ids_out = np.full((len(queries), k), -1, dtype=np.int64)
        sims_out = np.zeros((len(queries), k), dtype=np.float32)
        a_all = np.bitwise_count(queries).sum(-1)
        los, his = bb.bound_range_np(full_cnt, a_all, self.cutoff,
                                     metric=self.metric)
        lo_cnt, hi_cnt = bb.bound_counts_np(a_all, self.cutoff,
                                            metric=self.metric)
        d_cnt = st.delta_counts
        scanned = 0
        for qi, q in enumerate(queries):
            lo, hi = los[qi], his[qi]
            d_idx = np.where((d_cnt >= lo_cnt[qi]) & (d_cnt <= hi_cnt[qi]))[0]
            n_win = (hi - lo) + len(d_idx)
            if n_win <= 0:
                continue
            scanned += n_win
            cnt_w = np.concatenate([full_cnt[lo:hi], d_cnt[d_idx]])
            mo = np.argsort(cnt_w, kind="stable")
            fold_w = np.concatenate(
                [folded[lo:hi], st.delta_folded[d_idx]])[mo]
            fcnt_w = np.concatenate(
                [folded_cnt[lo:hi], st.delta_folded_counts[d_idx]])[mo]
            full_w = np.concatenate([full[lo:hi], st.delta_db[d_idx]])[mo]
            cnt_w = cnt_w[mo]
            gids_w = np.concatenate([order[lo:hi], n_main_v + d_idx])[mo]
            qf = fl.fold(q[None], self.m, self.scheme)[0]
            s1 = self._np_scores(qf, fold_w, fcnt_w)
            kr1_eff = min(kr1, n_win)
            cand = np.argsort(-s1, kind="stable")[:kr1_eff]
            s2 = self._np_scores(q, full_w[cand], cnt_w[cand])
            k_eff = min(k, len(cand))
            best = np.argsort(-s2, kind="stable")[:k_eff]
            ids_out[qi, :k_eff] = gids_w[cand[best]]
            sims_out[qi, :k_eff] = s2[best]
        self._record_batch(scanned, len(queries))
        return ids_out, sims_out

    # -- device-resident fixed-shape path -----------------------------------
    def _device_meta(self) -> dict:
        cap = self.store.main.capacity
        if self._device_state is not None and \
                self._device_state["capacity"] == cap:
            return self._device_state
        tile = kops._pick_tile(cap, None)
        self._device_state = {"tile": tile,
                              "total_tiles": (cap + tile - 1) // tile,
                              "capacity": cap}
        return self._device_state

    def _make_stage1(self, bucket: int, k1m: int):
        """Stage 1: the row-window kernel over each query's tile window of
        the folded main segment -> per-query top-``k1m`` candidate rows."""
        tile = self._device_meta()["tile"]
        metric = self.metric

        def stage1_main(qf, folded, folded_cnt, lo_row, hi_row):
            return kops.window_topk(qf, folded, folded_cnt, lo_row, hi_row,
                                    k=k1m, max_tiles=bucket, tile_n=tile,
                                    metric=metric)

        return stage1_main

    def _make_delta_select(self, k1m: int, k1c: int, delta_bucket: int):
        """Main+delta candidate merge: stage-1 scores for both segments,
        merged in the *rebuilt* global popcount-sorted order and truncated
        to ``k1c`` candidates."""
        capacity = self._device_meta()["capacity"]
        metric = self.metric
        BIG = 2**30

        def select(qf, cand, s1, full_cnt, order, d_folded, d_cnt,
                   d_folded_cnt, d_ok, n_main):
            s1d = metric_from_counts(metric, intersections(qf, d_folded),
                                     popcount(qf)[:, None],
                                     d_folded_cnt[None, :])
            s1d = torch.where(d_ok, s1d, NEG_INF)
            # virtual position of every candidate in the merged popcount-
            # sorted array (= the rebuilt sorted row): main row r keeps rank
            # r + |delta with cnt < cnt[r]|; delta row d gets its stable
            # (cnt, insertion-order) rank + |main with cnt <= cnt[d]|
            d_sorted = torch.sort(d_cnt).values               # pads: PAD_COUNT
            d_rank = torch.argsort(torch.argsort(d_cnt, stable=True))
            pos_d = (d_rank + torch.searchsorted(full_cnt, d_cnt, right=True)
                     ).to(torch.int32)
            safe_c = cand.clamp(0, capacity - 1).long()
            pos_m = cand + torch.searchsorted(
                d_sorted, full_cnt[safe_c]).to(torch.int32)
            pos_m = torch.where(cand >= 0, pos_m, BIG)
            s_all = torch.cat([s1, s1d], dim=1)               # (Q, k1m + D)
            pos_all = torch.cat([pos_m, pos_d[None, :].expand_as(s1d)], dim=1)
            # stage-1 truncation in rebuilt order: score desc, position asc
            # (two stable sorts: the secondary key first)
            by_pos = torch.argsort(pos_all, dim=1, stable=True)
            by_score = torch.argsort(torch.gather(s_all, 1, by_pos), dim=1,
                                     descending=True, stable=True)
            sel = torch.gather(by_pos, 1, by_score)[:, :k1c]
            sel_s = torch.gather(s_all, 1, sel)
            valid = torch.isfinite(sel_s)
            is_d = sel >= k1m
            cand_sel = torch.gather(cand, 1, sel.clamp(0, k1m - 1))
            d_slot = (sel - k1m).clamp(0, delta_bucket - 1)
            safe_m = cand_sel.clamp(0, capacity - 1).long()
            gids = torch.where(is_d, (n_main + d_slot).to(torch.int32),
                               order[safe_m])
            gids = torch.where(valid, gids, -1)
            return sel_s, valid, is_d, d_slot, safe_m, gids

        return select

    def _build_device_search(self, bucket: int, k: int, delta_bucket: int):
        """The two-stage pipeline for <= ``bucket``-tile main windows and a
        ``delta_bucket``-row delta segment (0 = no delta). All segment arrays
        are arguments, so a pipeline survives compactions that keep the
        capacity."""
        capacity = self._device_meta()["capacity"]
        m, scheme = self.m, self.scheme
        kr1 = max(fl.kr1_for(k, m), k)
        k1m = min(kr1, capacity)
        stage1_main = self._make_stage1(bucket, k1m)
        metric = self.metric

        def rescore(queries, rows, cnts, valid):
            inter = popcount(queries[:, None, :] & rows)
            s2 = metric_from_counts(metric, inter, popcount(queries)[:, None],
                                    cnts)
            return torch.where(valid, s2, NEG_INF)

        def finish(vals, gids, ok, lo_row, hi_row, extra_scanned):
            k_out = vals.shape[1]
            ids = torch.where(ok, gids, -1)
            sims = torch.where(ok, vals, 0.0).to(torch.float32)
            if k_out < k:                               # k > N degenerate pad
                ids = torch.nn.functional.pad(ids, (0, k - k_out), value=-1)
                sims = torch.nn.functional.pad(sims, (0, k - k_out))
            scanned = (hi_row - lo_row).clamp(min=0).sum() + extra_scanned
            return ids, sims, scanned

        if delta_bucket == 0:
            k_out = min(k, k1m)

            def run(queries, lo_row, hi_row, folded, folded_cnt, full,
                    full_cnt, order):
                qf = fl.fold_torch(queries, m, scheme)
                cand, s1 = stage1_main(qf, folded, folded_cnt, lo_row, hi_row)
                valid = cand >= 0
                safe = cand.clamp(0, capacity - 1).long()
                if m == 1:
                    # folded == full: stage-1 scores are already exact
                    vals, ok = s1[:, :k_out], valid[:, :k_out]
                    gids = order[safe[:, :k_out]]
                else:
                    s2 = rescore(queries, full[safe], full_cnt[safe], valid)
                    vals, pos = stable_topk(s2, k_out)
                    top = torch.gather(safe, 1, pos)
                    ok = torch.isfinite(vals)
                    gids = order[top]
                return finish(vals, gids, ok, lo_row, hi_row, 0)

            return run

        # -- main + delta: merge stage-1 candidates in the rebuilt global
        # popcount-sorted order before the kr1 truncation
        k1c = min(kr1, k1m + delta_bucket)
        k_out = min(k, k1c)
        select = self._make_delta_select(k1m, k1c, delta_bucket)

        def run(queries, lo_row, hi_row, folded, folded_cnt, full, full_cnt,
                order, d_full, d_folded, d_cnt, d_folded_cnt, d_ok, n_main):
            qf = fl.fold_torch(queries, m, scheme)
            cand, s1 = stage1_main(qf, folded, folded_cnt, lo_row, hi_row)
            sel_s, valid, is_d, d_slot, safe_m, gids = select(
                qf, cand, s1, full_cnt, order, d_folded, d_cnt,
                d_folded_cnt, d_ok, n_main)
            if m == 1:
                vals, ok = sel_s[:, :k_out], valid[:, :k_out]
                top_g = gids[:, :k_out]
            else:
                rows = torch.where(is_d[..., None], d_full[d_slot],
                                   full[safe_m])
                cnts = torch.where(is_d, d_cnt[d_slot], full_cnt[safe_m])
                s2 = rescore(queries, rows, cnts, valid)
                vals, p = stable_topk(s2, k_out)
                top_g = torch.gather(gids, 1, p)
                ok = torch.isfinite(vals)
            return finish(vals, top_g, ok, lo_row, hi_row, d_ok.sum())

        return run

    def search_device(self, queries, k: int):
        """Fixed-shape device path -> ``(ids, sims, scanned)`` tensors.

        Host work is only the window metadata (two searchsorteds and the
        delta popcount mask per batch, and the power-of-two tile bucket that
        sizes the window kernel's ``max_tiles``); the scans, merge, gather,
        rescore and top-k run on the engine's device."""
        self._sync()
        state = self._device_meta()
        tile, total_tiles = state["tile"], state["total_tiles"]
        q = self._queries(queries)
        q_np = words_np(q) if not isinstance(queries, np.ndarray) else \
            np.asarray(queries, dtype=np.uint32)
        a = np.bitwise_count(q_np).sum(-1)
        lo, hi = bb.bound_range_np(self.store.main.counts, a, self.cutoff,
                                   metric=self.metric)
        n_tiles = np.where(hi > lo, (hi + tile - 1) // tile - lo // tile, 0)
        max_window = int(n_tiles.max(initial=0))
        bucket = bb.bucket_tiles(max_window, total_tiles)
        self.stats.update(window_tiles_max=max_window, window_bucket=bucket,
                          tile=tile)
        dd = self._delta_dev
        delta_bucket = dd["bucket"] if dd is not None else 0
        lo_t = torch.as_tensor(lo, dtype=torch.int32).to(self.device)
        hi_t = torch.as_tensor(hi, dtype=torch.int32).to(self.device)
        fn = self._cached(
            (bucket, int(k), delta_bucket, state["capacity"]),
            lambda: self._build_device_search(bucket, k, delta_bucket))
        if dd is None:
            ids, sims, scanned = fn(q, lo_t, hi_t, self.folded,
                                    self.folded_cnt, self.full,
                                    self.full_cnt, self.order)
        else:
            lo_cnt, hi_cnt = bb.bound_counts_np(a, self.cutoff,
                                                metric=self.metric)
            d_cnt_np = self.store.delta_counts
            ok_np = np.zeros((q_np.shape[0], delta_bucket), dtype=bool)
            ok_np[:, :d_cnt_np.shape[0]] = (
                (d_cnt_np[None, :] >= lo_cnt[:, None]) &
                (d_cnt_np[None, :] <= hi_cnt[:, None]))
            ids, sims, scanned = fn(q, lo_t, hi_t, self.folded,
                                    self.folded_cnt, self.full,
                                    self.full_cnt, self.order,
                                    dd["full"], dd["folded"], dd["cnt"],
                                    dd["folded_cnt"],
                                    torch.from_numpy(ok_np).to(self.device),
                                    self.store.n_main)
        self._record_batch(scanned, q_np.shape[0])
        return ids, sims, scanned


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Top-K matching rate vs brute force (paper's accuracy definition)."""
    hits = 0
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(int(x) for x in p if x >= 0) & set(int(x) for x in t))
    return hits / true_ids.size
