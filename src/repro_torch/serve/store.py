"""Mutable LSM-style fingerprint store — the serving-time database layout.

The paper's host appends new compounds without stalling the scan engines;
BitBound (Eq. 2) needs the scanned segment popcount-sorted, and the folded
stage-1 arrays must stay consistent with the full-resolution rows. This
module reconciles the two with a two-segment LSM layout:

* **main segment** — immutable between compactions. For sorted stores
  (BitBound engines) the rows are popcount-sorted with ``order`` mapping
  sorted row -> global id; for unsorted stores (brute force) rows sit in
  global-id order and ``order`` is the identity. The arrays are padded to a
  power-of-two ``capacity`` (pad rows are zero; pad *counts* are
  ``PAD_COUNT`` in sorted mode so every Eq. 2 searchsorted window ends
  before the pads) — device pipelines keyed on the array shapes therefore
  survive compactions that don't cross a capacity boundary.
* **delta segment** — append-only, unsorted, in insertion (= global-id)
  order. Inserts are O(batch): no re-sort, no re-fold of the main segment.
  Folded delta rows are maintained eagerly so two-stage engines can scan
  the delta at stage-1 resolution.

**Compaction** is threshold-triggered (``compact_threshold`` delta rows):
the delta is merged into a fresh main segment — rows re-sorted by popcount
(stable, so equal-popcount rows stay in global-id order: exactly the order
a from-scratch popcount sort of the whole database would produce) and
re-folded. ``generation`` bumps on compaction, ``delta_version`` on every
write; engines use the two counters to invalidate device-resident copies.

Global ids are assigned monotonically (0..n_total-1) and are stable across
compactions, so engine results are comparable to a from-scratch rebuild on
the concatenated database — the insert-then-search parity contract.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import folding as fl

# Pad sentinel for sorted-mode counts: larger than any reachable Eq.2 upper
# bound (hi_cnt = a / max(cutoff, 1e-6) <= 1024e6 < 2**31 - 1), so windows
# computed by searchsorted always end at or before the last valid row.
PAD_COUNT = np.iinfo(np.int32).max


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _popcounts(rows: np.ndarray) -> np.ndarray:
    return np.bitwise_count(rows).sum(axis=-1).astype(np.int64)


def validate_rows(fps, words: int | None = None) -> np.ndarray:
    """Validate an insert batch up front: returns a ``(N, W)`` uint32 array
    or raises a clear ``ValueError``.

    Accepted dtypes are ``uint32`` (the packed-word format) and unsigned
    integer types that cast to it losslessly (``uint8`` / ``uint16``).
    Anything else — floats, signed ints (what a bare python list becomes),
    objects — is rejected here instead of surfacing later as a cryptic
    kernel shape/dtype error deep in a compiled pipeline.
    """
    arr = np.asarray(fps)
    if arr.dtype != np.uint32:
        if not (arr.dtype.kind == "u"
                and np.can_cast(arr.dtype, np.uint32, "safe")):
            raise ValueError(
                "fingerprint rows must be packed uint32 words "
                f"(or a losslessly-castable unsigned dtype), got {arr.dtype}")
        arr = arr.astype(np.uint32)
    arr = np.atleast_2d(arr)
    if arr.ndim != 2:
        raise ValueError(
            f"fingerprint rows must be (N, W) packed words, got shape "
            f"{arr.shape}")
    if words is not None and arr.shape[1] != words:
        raise ValueError(
            f"fingerprint width {arr.shape[1]} != store width {words}")
    return arr


@dataclass
class MainSegment:
    """Immutable (between compactions) capacity-padded fingerprint segment."""
    db: np.ndarray               # (capacity, W) uint32; pad rows zero
    counts: np.ndarray           # (capacity,) int64; pads PAD_COUNT (sorted) / 0
    order: np.ndarray            # (capacity,) int64 row -> global id; pads -1
    folded: np.ndarray | None    # (capacity, W/m) uint32 (None when unfolded)
    folded_counts: np.ndarray | None   # (capacity,) int64; pads 0
    n: int                       # valid rows
    capacity: int


class MutableFingerprintStore:
    """Two-segment (main + delta) mutable fingerprint database.

    Parameters
    ----------
    db : (N, W) uint32 packed fingerprints, in global-id order.
    sorted_main : popcount-sort the main segment (BitBound layout). When
        False the main segment keeps global-id order (brute-force layout).
    fold_m / fold_scheme : stage-1 folding level for the main+delta folded
        arrays (``m=1`` stores aliases of the full-resolution arrays).
    compact_threshold : delta row count that triggers compaction on insert.
    """

    def __init__(self, db: np.ndarray, *, sorted_main: bool = True,
                 fold_m: int = 1, fold_scheme: int = 1,
                 compact_threshold: int = 4096):
        db = np.atleast_2d(np.asarray(db, dtype=np.uint32))
        if db.ndim != 2:
            raise ValueError(f"db must be (N, W) packed words, got {db.shape}")
        self.words = db.shape[1]
        self.sorted_main = bool(sorted_main)
        self.fold_m = int(fold_m)
        self.fold_scheme = int(fold_scheme)
        self.compact_threshold = max(int(compact_threshold), 1)
        self.generation = 0
        self.delta_version = 0
        self.compactions = 0
        self.main = self._build_main(db)
        self._reset_delta()

    # -- segment construction ------------------------------------------------
    def _build_main(self, rows: np.ndarray) -> MainSegment:
        """Build a fresh main segment from rows given in global-id order."""
        n = rows.shape[0]
        capacity = next_pow2(max(n, 1))
        counts = _popcounts(rows)
        if self.sorted_main:
            order = np.argsort(counts, kind="stable").astype(np.int64)
            rows = rows[order]
            counts = counts[order]
        else:
            order = np.arange(n, dtype=np.int64)
        db = np.zeros((capacity, self.words), dtype=np.uint32)
        db[:n] = rows
        cnt = np.full((capacity,), PAD_COUNT if self.sorted_main else 0,
                      dtype=np.int64)
        cnt[:n] = counts
        order_p = np.full((capacity,), -1, dtype=np.int64)
        order_p[:n] = order
        if self.fold_m > 1:
            folded = np.zeros(
                (capacity, fl.folded_words(self.words, self.fold_m)),
                dtype=np.uint32)
            folded[:n] = fl.fold(db[:n], self.fold_m, self.fold_scheme)
        else:
            folded = db
        folded_counts = np.zeros((capacity,), dtype=np.int64)
        folded_counts[:n] = _popcounts(folded[:n])
        return MainSegment(db=db, counts=cnt, order=order_p, folded=folded,
                           folded_counts=folded_counts, n=n, capacity=capacity)

    def _reset_delta(self) -> None:
        wf = (fl.folded_words(self.words, self.fold_m)
              if self.fold_m > 1 else self.words)
        self.delta_db = np.zeros((0, self.words), dtype=np.uint32)
        self.delta_counts = np.zeros((0,), dtype=np.int64)
        self.delta_folded = np.zeros((0, wf), dtype=np.uint32)
        self.delta_folded_counts = np.zeros((0,), dtype=np.int64)

    # -- sizes ---------------------------------------------------------------
    @property
    def n_main(self) -> int:
        return self.main.n

    @property
    def n_delta(self) -> int:
        return self.delta_db.shape[0]

    @property
    def n_total(self) -> int:
        return self.main.n + self.delta_db.shape[0]

    # -- writes --------------------------------------------------------------
    def insert(self, fps: np.ndarray) -> np.ndarray:
        """Append fingerprints to the delta segment; returns their global
        ids. Triggers compaction when the delta reaches the threshold.
        Mis-shaped or mis-dtyped rows raise ``ValueError`` up front
        (:func:`validate_rows`) instead of corrupting the delta."""
        fps = validate_rows(fps, self.words)
        if fps.shape[0] == 0:
            return np.empty((0,), dtype=np.int64)
        gids = np.arange(self.n_total, self.n_total + fps.shape[0],
                         dtype=np.int64)
        self.delta_db = np.concatenate([self.delta_db, fps])
        self.delta_counts = np.concatenate(
            [self.delta_counts, _popcounts(fps)])
        folded = (fl.fold(fps, self.fold_m, self.fold_scheme)
                  if self.fold_m > 1 else fps)
        self.delta_folded = np.concatenate([self.delta_folded, folded])
        self.delta_folded_counts = np.concatenate(
            [self.delta_folded_counts, _popcounts(folded)])
        self.delta_version += 1
        if self.n_delta >= self.compact_threshold:
            self.compact()
        return gids

    # -- compaction ----------------------------------------------------------
    def rows_in_gid_order(self) -> np.ndarray:
        """All valid rows (main + delta) re-assembled in global-id order —
        the database a from-scratch rebuild would be given."""
        n = self.main.n
        rows = np.empty((n, self.words), dtype=np.uint32)
        rows[self.main.order[:n]] = self.main.db[:n]
        if self.n_delta:
            rows = np.concatenate([rows, self.delta_db])
        return rows

    def compact(self) -> None:
        """Merge the delta into a fresh sorted/folded main segment."""
        self.main = self._build_main(self.rows_in_gid_order())
        self._reset_delta()
        self.generation += 1
        self.delta_version += 1
        self.compactions += 1
