"""Carry a store's state into the port: the port's counterpart of weights.

:func:`store_from_reference_arrays` takes the arrays of a two-segment
fingerprint store as numpy (the popcount-sorted or id-ordered,
capacity-padded main segment and the append-only delta, with the store's
counters) and returns a :class:`MutableFingerprintStore` holding exactly
those arrays, without re-sorting or re-folding anything. Two systems
holding the same arrays search the very same state.
"""
from __future__ import annotations

import numpy as np

from ..core import folding as fl
from .store import MainSegment, MutableFingerprintStore, next_pow2


def store_from_reference_arrays(main: dict, delta: dict, *, n_main: int,
                                sorted_main: bool, fold_m: int,
                                fold_scheme: int = 1,
                                compact_threshold: int = 4096,
                                generation: int = 0, delta_version: int = 0,
                                compactions: int = 0
                                ) -> MutableFingerprintStore:
    """Build a store from ``main`` (``db``, ``counts``, ``order``,
    ``folded``, ``folded_counts``) and ``delta`` (``delta_db``,
    ``delta_counts``, ``delta_folded``, ``delta_folded_counts``) numpy
    arrays plus the counters. Shapes and dtypes are checked; the arrays are
    copied, so the caller's store and this one never alias."""
    db = np.array(main["db"], dtype=np.uint32)
    if db.ndim != 2:
        raise ValueError(f"main db must be (capacity, W), got {db.shape}")
    capacity, words = db.shape
    if capacity != next_pow2(max(int(n_main), 1)):
        raise ValueError(f"capacity {capacity} does not fit n_main={n_main}")
    wf = fl.folded_words(words, fold_m) if fold_m > 1 else words
    folded = (db if fold_m == 1
              else np.array(main["folded"], dtype=np.uint32))
    seg = MainSegment(
        db=db,
        counts=np.array(main["counts"], dtype=np.int64),
        order=np.array(main["order"], dtype=np.int64),
        folded=folded,
        folded_counts=np.array(main["folded_counts"], dtype=np.int64),
        n=int(n_main), capacity=int(capacity))
    for name in ("counts", "order", "folded_counts"):
        if getattr(seg, name).shape != (capacity,):
            raise ValueError(f"main {name} must have shape ({capacity},)")
    if seg.folded.shape != (capacity, wf):
        raise ValueError(f"main folded must have shape ({capacity}, {wf})")

    st = object.__new__(MutableFingerprintStore)
    st.words = int(words)
    st.sorted_main = bool(sorted_main)
    st.fold_m = int(fold_m)
    st.fold_scheme = int(fold_scheme)
    st.compact_threshold = max(int(compact_threshold), 1)
    st.generation = int(generation)
    st.delta_version = int(delta_version)
    st.compactions = int(compactions)
    st.main = seg
    st.delta_db = np.array(delta["delta_db"], dtype=np.uint32).reshape(-1, words)
    nd = st.delta_db.shape[0]
    st.delta_counts = np.array(delta["delta_counts"], dtype=np.int64).reshape(nd)
    st.delta_folded = np.array(delta["delta_folded"],
                               dtype=np.uint32).reshape(nd, wf)
    st.delta_folded_counts = np.array(delta["delta_folded_counts"],
                                      dtype=np.int64).reshape(nd)
    return st
