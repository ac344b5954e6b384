"""Port vs reference: packing, popcounts, metric scores, folds, top-k tie
order, the synthetic generator, BitBound windows and the store. The same
numpy inputs go through both packages; everything must be bit-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitbound as rbb
from repro.core import fingerprints as rfp
from repro.core import folding as rfl
from repro.core import topk as rtk
from repro.data import molecules as rmol
from repro.serve import store as rstore
from repro_torch.core import bitbound as pbb
from repro_torch.core import fingerprints as pfp
from repro_torch.core import folding as pfl
from repro_torch.core import topk as ptk
from repro_torch.data import molecules as pmol
from repro_torch.serve import store as pstore
from repro_torch.serve.state import store_from_reference_arrays

METRICS = ["tanimoto", "dice", "cosine", "tversky(0.7,0.3)"]


def _db(n, seed=0, length=1024):
    return rmol.synthetic_fingerprints(
        rmol.SyntheticConfig(n=n, seed=seed, length=length))


@pytest.mark.parametrize("length", [1024, 224])
def test_pack_unpack_popcount_byte_equal(length):
    rng = np.random.default_rng(length)
    bits = (rng.random((37, length)) < 0.3).astype(np.uint8)
    words = rfp.pack_bits(bits)
    np.testing.assert_array_equal(pfp.pack_bits(bits), words)
    np.testing.assert_array_equal(pfp.unpack_bits(words), rfp.unpack_bits(words))
    # full-range words: the sign bit of the int32 view must count
    raw = rng.integers(0, 2**32, (41, length // 32), dtype=np.uint32)
    raw[0] = 0xFFFFFFFF
    raw[1] = 0x80000000
    for w in (words, raw):
        got = pfp.popcount(pfp.as_words(w)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(rfp.popcount(jnp.asarray(w))))
    np.testing.assert_array_equal(pfp.words_np(pfp.as_words(raw)), raw)


@pytest.mark.parametrize("length", [1024, 224])
@pytest.mark.parametrize("metric", METRICS)
def test_scores_bit_equal(length, metric):
    db = _db(300, seed=3, length=length)
    db[:2] = 0                                   # empty prints: the 0 guard
    qs = np.concatenate([db[:1], rmol.queries_from_db(db, 6, seed=4)])
    rm, pm = rfp.resolve_metric(metric), pfp.resolve_metric(metric)
    assert pm.spec == rm.spec and pm.bound_ratios(0.7) == rm.bound_ratios(0.7)
    ref = np.asarray(rfp.batched_metric_scores(jnp.asarray(qs), jnp.asarray(db), rm))
    got = pfp.batched_metric_scores(pfp.as_words(qs), pfp.as_words(db), pm).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    oracle = pfp.batched_metric_scores_np(qs, db, pm)
    np.testing.assert_array_equal(oracle.view(np.int32), ref.view(np.int32))


def test_metric_specs_round_trip():
    for spec in ("tanimoto", "dice", "cosine", "tversky", "tversky(0.7,0.3)",
                 "tversky(1.0,0.0)"):
        assert pfp.resolve_metric(spec).spec == rfp.resolve_metric(spec).spec
    assert pfp.TVERSKY_SCALE == rfp.TVERSKY_SCALE
    with pytest.raises(ValueError):
        pfp.Metric("jaccard")


@pytest.mark.parametrize("length", [1024, 224])
@pytest.mark.parametrize("m,scheme", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
def test_fold_torch_matches_reference(length, m, scheme):
    rng = np.random.default_rng(m * 10 + scheme)
    words = rng.integers(0, 2**32, (23, length // 32), dtype=np.uint32)
    ref = np.asarray(rfl.fold_jax(jnp.asarray(words), m, scheme))
    np.testing.assert_array_equal(pfl.fold(words, m, scheme), ref)
    got = pfl.fold_torch(pfp.as_words(words), m, scheme)
    np.testing.assert_array_equal(pfp.words_np(got), ref)
    assert got.shape[-1] == pfl.folded_words(length // 32, m) == \
        rfl.folded_words(length // 32, m)
    assert pfl.kr1_for(20, m) == rfl.kr1_for(20, m)


def _metric_score_runs(n_runs, n, seed):
    """Descending score runs drawn from real metric scores (many ties)."""
    db = _db(400, seed=seed)
    qs = rmol.queries_from_db(db, n_runs, seed=seed + 1)
    s = pfp.batched_metric_scores_np(qs, db)[:, :n]
    return -np.sort(-s, axis=1)


def test_merge_sorted_keeps_run_a_on_ties():
    a = _metric_score_runs(8, 60, 5)
    b = _metric_score_runs(8, 45, 6)
    ia = np.arange(8 * 60, dtype=np.int32).reshape(8, 60)
    ib = 1000 + np.arange(8 * 45, dtype=np.int32).reshape(8, 45)
    for r in range(8):
        rs, ri = rtk.merge_sorted(jnp.asarray(a[r]), jnp.asarray(ia[r]),
                                  jnp.asarray(b[r]), jnp.asarray(ib[r]))
        ps, pi = ptk.merge_sorted(torch.from_numpy(a[r]), torch.from_numpy(ia[r]),
                                  torch.from_numpy(b[r]), torch.from_numpy(ib[r]))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    # the batched form equals the per-row form
    bs, bi = ptk.merge_sorted(torch.from_numpy(a), torch.from_numpy(ia),
                              torch.from_numpy(b), torch.from_numpy(ib))
    ps, pi = ptk.merge_sorted(torch.from_numpy(a[3]), torch.from_numpy(ia[3]),
                              torch.from_numpy(b[3]), torch.from_numpy(ib[3]))
    np.testing.assert_array_equal(bs[3].numpy(), ps.numpy())
    np.testing.assert_array_equal(bi[3].numpy(), pi.numpy())


@pytest.mark.parametrize("n,k,tile", [(400, 20, 128), (130, 64, 128),
                                      (50, 80, 32)])
def test_streaming_topk_lowest_index_first(n, k, tile):
    db = _db(n, seed=7)
    q = rmol.queries_from_db(db, 1, seed=8)
    s = pfp.batched_metric_scores_np(q, db)[0]
    rv, ri = rtk.streaming_topk(jnp.asarray(s), k, tile=tile)
    pv, pi = ptk.streaming_topk(torch.from_numpy(s), k, tile=tile)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_generator_byte_identical():
    for cfg in (dict(n=500, seed=0), dict(n=300, seed=5, length=224),
                dict(n=200, seed=2, bit_skew=1.1)):
        ref = rmol.synthetic_fingerprints(rmol.SyntheticConfig(**cfg))
        got = pmol.synthetic_fingerprints(pmol.SyntheticConfig(**cfg))
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
        np.testing.assert_array_equal(pmol.queries_from_db(got, 17, seed=3),
                                      rmol.queries_from_db(ref, 17, seed=3))


@pytest.mark.parametrize("metric", METRICS + ["tversky(0.0,0.0)"])
@pytest.mark.parametrize("cutoff", [0.05, 0.8, 0.99])
def test_bound_windows_exact(metric, cutoff):
    counts = np.sort(np.bitwise_count(_db(500, seed=9)).sum(-1))
    a = np.arange(0, 300)
    rm, pm = rfp.resolve_metric(metric), pfp.resolve_metric(metric)
    for r, p in zip(rbb.bound_counts_np(a, cutoff, rm),
                    pbb.bound_counts_np(a, cutoff, pm)):
        np.testing.assert_array_equal(p, r)
    for r, p in zip(rbb.bound_range_np(counts, a, cutoff, rm),
                    pbb.bound_range_np(counts, a, cutoff, pm)):
        np.testing.assert_array_equal(p, r)
    for n_t, total in [(0, 10), (1, 10), (3, 10), (9, 10), (17, 16)]:
        assert pbb.bucket_tiles(n_t, total) == rbb.bucket_tiles(n_t, total)


def _store_arrays(st):
    main = {name: getattr(st.main, name) for name in
            ("db", "counts", "order", "folded", "folded_counts")}
    delta = {name: getattr(st, name) for name in
             ("delta_db", "delta_counts", "delta_folded", "delta_folded_counts")}
    return main, delta


def _assert_same_store(p, r):
    pm, pd = _store_arrays(p)
    rm, rd = _store_arrays(r)
    for name in pm:
        np.testing.assert_array_equal(pm[name], rm[name], err_msg=name)
    for name in pd:
        np.testing.assert_array_equal(pd[name], rd[name], err_msg=name)
    assert (p.n_main, p.n_delta, p.generation, p.delta_version,
            p.compactions) == (r.n_main, r.n_delta, r.generation,
                               r.delta_version, r.compactions)


@pytest.mark.parametrize("sorted_main,m,scheme", [(True, 4, 1), (True, 2, 2),
                                                  (False, 1, 1)])
def test_store_matches_reference_across_compaction(sorted_main, m, scheme):
    db = _db(700, seed=11)
    extra = _db(60, seed=12)
    kw = dict(sorted_main=sorted_main, fold_m=m, fold_scheme=scheme,
              compact_threshold=40)
    r = rstore.MutableFingerprintStore(db, **kw)
    p = pstore.MutableFingerprintStore(db, **kw)
    _assert_same_store(p, r)
    for lo in range(0, 60, 25):
        np.testing.assert_array_equal(p.insert(extra[lo:lo + 25]),
                                      r.insert(extra[lo:lo + 25]))
        _assert_same_store(p, r)
    assert p.compactions == 1
    main, delta = _store_arrays(r)
    s = store_from_reference_arrays(
        main, delta, n_main=r.n_main, sorted_main=sorted_main, fold_m=m,
        fold_scheme=scheme, compact_threshold=40, generation=r.generation,
        delta_version=r.delta_version, compactions=r.compactions)
    _assert_same_store(s, r)
    assert pstore.PAD_COUNT == rstore.PAD_COUNT
    assert [pstore.next_pow2(n) for n in (0, 1, 5, 64, 65)] == \
        [rstore.next_pow2(n) for n in (0, 1, 5, 64, 65)]
    with pytest.raises(ValueError):
        pstore.validate_rows(np.zeros((2, 32), np.int64))
