"""Port engines vs reference engines on the very same store state.

The port's engines are built from the reference store's arrays
(``serve.state.store_from_reference_arrays``), then both systems take the
same inserts, through a compaction, and must return bit-identical ids and
f32 scores at every step: the port's device path (``backend="cuda"`` on
``device="cpu"``, i.e. the kernels' plain versions) against the
reference's ``jnp`` and ``tpu`` (Pallas interpret) backends, and the
port's ``search_numpy`` against the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import BitBoundFoldingEngine as RBitBound
from repro.core import BruteForceEngine as RBrute
from repro.data.molecules import SyntheticConfig, queries_from_db, synthetic_fingerprints
from repro_torch.core import BitBoundFoldingEngine, BruteForceEngine, recall_at_k
from repro_torch.serve.state import store_from_reference_arrays


def _port_store(st):
    main = {n: getattr(st.main, n) for n in
            ("db", "counts", "order", "folded", "folded_counts")}
    delta = {n: getattr(st, n) for n in
             ("delta_db", "delta_counts", "delta_folded", "delta_folded_counts")}
    return store_from_reference_arrays(
        main, delta, n_main=st.n_main, sorted_main=st.sorted_main,
        fold_m=st.fold_m, fold_scheme=st.fold_scheme,
        compact_threshold=st.compact_threshold, generation=st.generation,
        delta_version=st.delta_version, compactions=st.compactions)


def _same(got, want, label=""):
    gi, gs = got
    wi, ws = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi, err_msg=label)
    np.testing.assert_array_equal(np.asarray(gs, np.float32).view(np.int32),
                                  ws.astype(np.float32).view(np.int32),
                                  err_msg=label)


def _phases(ref, port, extra, qs, k, check):
    """Search, insert 3 batches (compaction after the second), search again
    after each — the two systems must agree at every step."""
    check(0)
    for i, lo in enumerate(range(0, len(extra), len(extra) // 3)):
        rows = extra[lo:lo + len(extra) // 3]
        np.testing.assert_array_equal(port.insert(rows), ref.insert(rows))
        check(i + 1)
    assert port.store.compactions == ref.store.compactions == 1


@pytest.mark.parametrize("backend,metric", [
    ("jnp", "tanimoto"), ("tpu", "tanimoto"), ("jnp", "dice"),
    ("jnp", "cosine"), ("tpu", "tversky(0.7,0.3)")])
def test_brute_matches_reference_across_inserts(small_db, queries, backend,
                                                metric):
    ref = RBrute(small_db[:1500], backend=backend, metric=metric,
                 compact_threshold=300)
    port = BruteForceEngine(None, store=_port_store(ref.store), metric=metric,
                            device="cpu")

    def check(phase):
        _same(port.search(queries, 20), ref.search(queries, 20), f"phase {phase}")
        assert port.scanned(len(queries)) == ref.scanned(len(queries))

    _phases(ref, port, small_db[1500:1950], queries, 20, check)


@pytest.mark.parametrize("m,scheme,cutoff,metric", [
    (1, 1, 0.6, "tanimoto"),
    (2, 1, 0.8, "tanimoto"),
    (4, 1, 0.8, "tanimoto"),
    (4, 2, 0.6, "tanimoto"),
    (4, 1, 0.8, "dice"),
    (2, 1, 0.7, "tversky(0.7,0.3)"),
    (4, 1, 0.6, "cosine"),
])
def test_bitbound_matches_reference_across_inserts(small_db, queries, m,
                                                   scheme, cutoff, metric):
    ref = RBitBound(small_db[:1500], cutoff=cutoff, m=m, scheme=scheme,
                    backend="tpu", metric=metric, compact_threshold=300)
    port = BitBoundFoldingEngine(None, cutoff=cutoff, m=m, scheme=scheme,
                                 backend="cuda", metric=metric, device="cpu",
                                 store=_port_store(ref.store))

    def check(phase):
        want = ref.search(queries, 20)
        _same(port.search(queries, 20), want, f"device, phase {phase}")
        assert port.scanned(len(queries)) == ref.scanned(len(queries))
        _same(port.search_numpy(queries, 20), ref.search_numpy(queries, 20),
              f"numpy, phase {phase}")
        if m == 1:   # pure BitBound: the device path equals the host oracle
            _same(port.search_numpy(queries, 20), want, f"m=1, phase {phase}")

    _phases(ref, port, small_db[1500:1950], queries, 20, check)


def test_bitbound_matches_reference_jnp_backend(small_db, queries):
    ref = RBitBound(small_db, cutoff=0.7, m=4, backend="jnp")
    port = BitBoundFoldingEngine(small_db, cutoff=0.7, m=4, backend="cuda",
                                 device="cpu")
    _same(port.search(queries, 10), ref.search(queries, 10))
    ids, sims, scanned = port.search_device(queries, 10)
    assert isinstance(ids, torch.Tensor) and ids.shape == (len(queries), 10)
    assert int(scanned) == port.scanned(len(queries))
    assert port.stats["window_bucket"] >= port.stats["window_tiles_max"]


def test_empty_windows_at_high_cutoff(small_db):
    """Queries whose Eq.2 window is empty come back id -1 / sim 0."""
    q = np.zeros((3, small_db.shape[1]), dtype=np.uint32)
    q[1] = small_db[0]
    q[2, 0] = 0b111
    ref = RBitBound(small_db, cutoff=0.99, m=1, backend="tpu")
    port = BitBoundFoldingEngine(small_db, cutoff=0.99, m=1, backend="cuda",
                                 device="cpu")
    ids, sims = port.search(q, 10)
    _same((ids, sims), ref.search(q, 10))
    _same(port.search_numpy(q, 10), ref.search_numpy(q, 10))
    assert (ids[0] == -1).all() and (sims[0] == 0).all()


@pytest.mark.parametrize("metric", ["tanimoto", "dice", "cosine",
                                    "tversky(0.7,0.3)"])
def test_odd_width_224_bits(metric):
    db = synthetic_fingerprints(SyntheticConfig(n=900, seed=4, length=224))
    qs = queries_from_db(db, 8, seed=5)
    rb = RBrute(db, backend="tpu", metric=metric, fp_bits=224)
    pb = BruteForceEngine(db, metric=metric, fp_bits=224, device="cpu")
    _same(pb.search(qs, 15), rb.search(qs, 15), f"brute {metric}")
    rf = RBitBound(db, cutoff=0.6, m=4, backend="tpu", metric=metric,
                   fp_bits=224)
    pf = BitBoundFoldingEngine(db, cutoff=0.6, m=4, backend="cuda",
                               metric=metric, fp_bits=224, device="cpu")
    _same(pf.search(qs, 15), rf.search(qs, 15), f"bitbound {metric}")
    _same(pf.search_numpy(qs, 15), rf.search_numpy(qs, 15), f"numpy {metric}")
    with pytest.raises(ValueError, match="fp_bits"):
        BruteForceEngine(db, fp_bits=1024, device="cpu")


def test_folded_recall_and_scanned_contract(small_db, queries, brute_truth):
    _, true_ids = brute_truth
    brute = BruteForceEngine(small_db, device="cpu")
    ids, _ = brute.search(queries, 20)
    assert recall_at_k(ids, true_ids) == 1.0
    assert brute.scanned(5) == 5 * small_db.shape[0]
    dev = BitBoundFoldingEngine(small_db, cutoff=0.6, m=4, backend="cuda",
                                device="cpu")
    host = BitBoundFoldingEngine(small_db, cutoff=0.6, m=4, backend="numpy",
                                 device="cpu")
    assert dev.scanned(16) == host.scanned(16) == 0
    dids, _ = dev.search(queries, 20)
    hids, _ = host.search(queries, 20)
    assert recall_at_k(dids, true_ids) >= recall_at_k(hids, true_ids) - 1 / true_ids.size
    assert dev.scanned(2 * len(queries)) == 2 * host.scanned(len(queries)) > 0


def test_backend_and_device_validation(small_db):
    with pytest.raises(TypeError, match="backend"):
        BruteForceEngine(small_db, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        BitBoundFoldingEngine(small_db, backend="tpu", device="cpu")
    assert BitBoundFoldingEngine(small_db, device="cpu").backend == "cuda"
    for cls in (BruteForceEngine, BitBoundFoldingEngine):
        assert cls.__dataclass_fields__["device"].default == "cuda"
    with pytest.raises(ValueError, match="layout"):
        BruteForceEngine(None, store=BitBoundFoldingEngine(
            small_db, device="cpu").store, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BruteForceEngine(small_db)
        with pytest.raises(RuntimeError, match="CUDA"):
            BitBoundFoldingEngine(small_db)
        # the host reference needs no card
        assert BitBoundFoldingEngine(small_db, backend="numpy").search(
            small_db[:1], 3)[0].shape == (1, 3)
