#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the repository root

Phases, each of which exits non-zero on any failure:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, into
   ``build/``) and print the card's name and power limit.
2. Hold each kernel bit-identical (ids and f32 scores) to its plain PyTorch
   version at a small odd shape (N=5000, W=7) for all four metrics.
3. Drive the main path at ChEMBL scale (``CHEMBL_LIKE``: 1,941,405 rows of
   1024 bits, k=20, Sc=0.8, m=4, scheme 1): ``BruteForceEngine`` and
   ``BitBoundFoldingEngine(backend="cuda")`` on four 1024-query batches,
   then twice 1,000 inserts and the same batches through main+delta. The
   kernels' launch counts are read around exactly this phase.
4. Check the results: brute force equals the plain full score matrix plus
   a stable sort on the card; BitBound at m=1 equals the port's
   ``search_numpy``; BitBound at m=4 keeps recall@20 at or above
   ``search_numpy``'s (less one hit, as the reference's own device-path test
   allows); every window bucket covers its batch's largest window; each
   kernel equals its plain version at the full shape for 64 queries.
5. Time each kernel at the main path's shapes (1024 queries) beside its
   plain version, ``torch.topk`` over a score matrix (the library
   yardstick, never used by the port) and the least time the card could
   take; the timed kernel and plain outputs must be bit-identical too.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line
and, last, ``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_ROWS = 1_941_405          # ChEMBL 27.1 (CHEMBL_LIKE.n_molecules)
CHUNK = 100_000             # rows per generator call (host memory)
BATCH = 1024                # CHEMBL_LIKE.queries_per_batch
N_BATCHES = 4               # distinct query batches per phase
N_INSERT = 1000             # rows per insert; two inserts
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
POPC_PER_CLK_PER_SM = 16    # 32-bit popcount issue rate, compute capability 9.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip-smoke] {msg}", flush=True)


def _chunk(args):
    n, seed = args
    from repro_torch.data.molecules import SyntheticConfig, synthetic_fingerprints
    return synthetic_fingerprints(SyntheticConfig(n=n, seed=seed))


def make_db(n_rows, workers):
    """The database in 100k-row generator chunks (seed = chunk index)."""
    import numpy as np
    jobs = [(min(CHUNK, n_rows - lo), i)
            for i, lo in enumerate(range(0, n_rows, CHUNK))]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        parts = list(ex.map(_chunk, jobs))
    return np.concatenate(parts)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, and the
    last call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


#: largest |kernel - plain| score seen per kernel over all comparisons
MAX_ABS_ERR = {"tanimoto_topk": 0.0, "window_topk": 0.0}


def compare(name, got, want, msg):
    """Require ids and f32 scores bit-identical; record the score error."""
    import torch
    (ia, va), (ib, vb) = got, want
    same_inf = torch.equal(torch.isinf(va), torch.isinf(vb))
    fin = torch.isfinite(va) & torch.isfinite(vb)
    err = float((va[fin] - vb[fin]).abs().max()) if bool(fin.any()) else 0.0
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name], err if same_inf else math.inf)
    check(torch.equal(ia, ib) and torch.equal(va.view(torch.int32),
                                              vb.view(torch.int32)),
          f"{name} != plain version {msg} (max |err| {err})")


def score_matrix(queries, db, cnt, metric, block=128):
    """(Q, N) f32 scores, a block of queries at a time."""
    import torch
    from repro_torch.kernels import ref
    out = torch.empty((queries.shape[0], db.shape[0]), dtype=torch.float32,
                      device=db.device)
    for q0 in range(0, queries.shape[0], block):
        out[q0:q0 + block] = ref.tanimoto_scores_ref(queries[q0:q0 + block],
                                                     db, cnt, metric=metric)
    return out


def profile_search(eng, qb, k):
    """One search under ``torch.profiler``: device time by kernel name and
    the device's busy share of the (profiled) wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.search(qb, k)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": ev.key[:80], "ms": dev_us / 1e3,
                         "calls": ev.count})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if rows else None,
            "top": rows[:8]}


def phase_small(dev):
    """Both kernels vs their plain versions at N=5000, W=7, all metrics."""
    import numpy as np
    import torch
    from repro_torch.core.fingerprints import as_words, popcount, resolve_metric
    from repro_torch.data.molecules import SyntheticConfig, synthetic_fingerprints
    from repro_torch.kernels import ops, ref
    db_np = synthetic_fingerprints(SyntheticConfig(n=5000, seed=21))[:, :7]
    db_np = db_np[np.argsort(np.bitwise_count(db_np).sum(-1), kind="stable")]
    db = as_words(np.ascontiguousarray(db_np), dev)
    cnt = popcount(db)
    qs = db[3::137].contiguous()                  # 37 queries
    lo = torch.arange(qs.shape[0], device=dev, dtype=torch.int32) * 113
    hi = lo + torch.arange(qs.shape[0], device=dev, dtype=torch.int32) * 29
    for spec in ("tanimoto", "dice", "cosine", "tversky(0.7,0.3)"):
        met = resolve_metric(spec)
        for k in (20, 240):
            got = ops.tanimoto_topk(qs, db, k, db_popcount=cnt, metric=met)
            compare("tanimoto_topk", got,
                    ref.tanimoto_topk_ref(qs, db, k, cnt, metric=met),
                    f"at N=5000 W=7 {spec} k={k}")
            for max_tiles in (None, 2):
                got = ops.window_topk(qs, db, cnt, lo, hi, k,
                                      max_tiles=max_tiles, metric=met)
                wlo, whi = ops.window_bounds(lo, hi, db.shape[0], max_tiles,
                                             None, dev)
                want = ref.window_topk_ref(qs, db, cnt, wlo, whi, k, metric=met)
                compare("window_topk", got, want, f"at N=5000 W=7 {spec} "
                        f"k={k} max_tiles={max_tiles}")
    torch.cuda.synchronize()
    log("small odd shape: both kernels bit-identical to plain, 4 metrics")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch sees no CUDA device")
    from repro_torch.configs import CHEMBL_LIKE
    from repro_torch.core import BitBoundFoldingEngine, BruteForceEngine, recall_at_k
    from repro_torch.core import bitbound as bb
    from repro_torch.core import folding as fl
    from repro_torch.core.fingerprints import TANIMOTO, as_words, popcount
    from repro_torch.data.molecules import (SyntheticConfig, queries_from_db,
                                            synthetic_fingerprints)
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda", 0)
    record = {"device": torch.cuda.get_device_name(0)}
    smi_line = smi("name,power.limit")
    log(f"card: {smi_line}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.lib()
    record["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {record['build_s']:.1f} s -> {lib.name}")
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line:
                log(f"ptxas: {line.strip()}")

    phase_small(dev)

    # -- main path at ChEMBL scale ------------------------------------------
    cfg = CHEMBL_LIKE
    t0 = time.perf_counter()
    db = make_db(N_ROWS, workers=min(6, os.cpu_count() or 1))
    record["db_gen_s"] = time.perf_counter() - t0
    check(db.shape == (cfg.n_molecules, cfg.fp_len // 32), f"db shape {db.shape}")
    log(f"database {db.shape} generated in {record['db_gen_s']:.1f} s")
    queries = queries_from_db(db, N_BATCHES * BATCH, seed=1)
    inserts = [synthetic_fingerprints(SyntheticConfig(n=N_INSERT, seed=s))
               for s in (10_001, 10_002)]
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(N_BATCHES)]

    t0 = time.perf_counter()
    brute = BruteForceEngine(db, device=dev)
    bb4 = BitBoundFoldingEngine(db, cutoff=cfg.cutoff, m=cfg.folding_m,
                                scheme=cfg.folding_scheme, backend="cuda",
                                device=dev)
    record["engine_build_s"] = time.perf_counter() - t0
    engines = {"brute": brute, "bitbound-folding": bb4}
    results = {name: {"latency_ms": [], "scanned_per_query": []}
               for name in engines}

    def drive(name, eng, qb):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.search(qb, cfg.k)              # numpy out: the device is done
        results[name]["latency_ms"].append((time.perf_counter() - t) * 1e3)
        results[name]["scanned_per_query"].append(eng.scanned(1))
        if name == "bitbound-folding":
            st = eng.stats
            check(st["window_bucket"] >= st["window_tiles_max"],
                  f"window bucket {st['window_bucket']} < largest window "
                  f"{st['window_tiles_max']} tiles")

    ops.reset_launch_counts()
    for phase in range(1 + len(inserts)):
        if phase:
            for eng in engines.values():
                eng.insert(inserts[phase - 1])
        for name, eng in engines.items():
            for qb in batches:
                drive(name, eng, qb)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"main path launches: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the main path")
    for name, res in results.items():
        lat = res["latency_ms"]
        # every batch after the very first (uploads, first launches), the
        # first batch after each insert included
        timed = lat[1:]
        res["qps"] = BATCH * len(timed) / (sum(timed) / 1e3)
        res["batch_latency_ms_median"] = float(np.median(timed))
        res["post_insert_first_batch_ms"] = lat[N_BATCHES::N_BATCHES]
        steady = [x for i, x in enumerate(lat) if i % N_BATCHES]
        res["qps_steady"] = BATCH * len(steady) / (sum(steady) / 1e3)
        log(f"{name}: {res['qps']:.1f} QPS over batches 2-{len(lat)} "
            f"({res['qps_steady']:.1f} without each phase's first batch), "
            f"median batch {res['batch_latency_ms_median']:.1f} ms, batch "
            f"latency ms {[round(x, 1) for x in lat]}, scanned/query "
            f"{res['scanned_per_query']}")
    record["main_path"] = {"launches": launches, "engines": results,
                           "n_rows": int(db.shape[0]),
                           "inserted": [N_INSERT] * len(inserts),
                           "batch": BATCH, "batches_per_phase": N_BATCHES}
    profiles = {name: profile_search(eng, batches[1], cfg.k)
                for name, eng in engines.items()}
    record["profile"] = profiles
    for name, prof in profiles.items():
        top = ", ".join(f"{r['name'][:40]} {r['ms']:.2f} ms x{r['calls']}"
                        for r in prof["top"][:4])
        log(f"profile {name}: wall {prof['wall_ms']:.1f} ms (profiled), "
            f"device busy {prof['device_busy_ms']:.1f} ms; top: {top}")

    # -- correctness at full scale -------------------------------------------
    qp = batches[0][:32]
    ids, sims = brute.search(qp, cfg.k)
    rows = as_words(brute.store.rows_in_gid_order(), dev)
    s = ref.tanimoto_scores_ref(as_words(qp, dev), rows)
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    check(np.array_equal(ids, i[:, :cfg.k].cpu().numpy().astype(ids.dtype)),
          "brute-force ids != plain score matrix + stable sort")
    check(np.array_equal(sims.view(np.int32),
                         v[:, :cfg.k].cpu().numpy().view(np.int32)),
          "brute-force scores != plain score matrix + stable sort")
    del rows, s, v, i
    truth = ids
    log("brute force (main+delta) bit-identical to plain full scan + stable sort")

    bb1 = BitBoundFoldingEngine(db, cutoff=cfg.cutoff, m=1, backend="cuda",
                                device=dev)
    for rows in inserts:
        bb1.insert(rows)
    d_ids, d_sims = bb1.search(qp, cfg.k)
    n_ids, n_sims = bb1.search_numpy(qp, cfg.k)
    check(np.array_equal(d_ids, n_ids) and np.array_equal(
        d_sims.view(np.int32), n_sims.view(np.int32)),
        "BitBound m=1 device path != search_numpy")
    log("BitBound m=1 (main+delta) bit-identical to search_numpy")
    del bb1
    d_ids, _ = bb4.search(qp, cfg.k)
    n_ids, _ = bb4.search_numpy(qp, cfg.k)
    rec_d, rec_n = recall_at_k(d_ids, truth), recall_at_k(n_ids, truth)
    record["recall_at_20"] = {"device": rec_d, "search_numpy": rec_n}
    check(rec_d >= rec_n - 1.0 / truth.size,
          f"BitBound m=4 recall {rec_d} < search_numpy's {rec_n}")
    log(f"BitBound m=4 recall@20 vs brute force: device {rec_d:.4f}, "
        f"search_numpy {rec_n:.4f}")

    # -- kernels at the main path's shapes -----------------------------------
    q_full = as_words(batches[0], dev)
    db_main, cnt_main = brute.db, brute.db_cnt          # (2^21, 32), capacity
    q64 = q_full[:64].contiguous()
    compare("tanimoto_topk",
            ops.tanimoto_topk(q64, db_main, cfg.k, db_popcount=cnt_main),
            ref.tanimoto_topk_ref(q64, db_main, cfg.k, cnt_main),
            "at the full shape (64 queries)")
    tile = bb4._device_meta()["tile"]
    total_tiles = bb4._device_meta()["total_tiles"]
    a = np.bitwise_count(batches[0]).sum(-1)
    lo, hi = bb.bound_range_np(bb4.store.main.counts, a, cfg.cutoff)
    n_tiles = np.where(hi > lo, (hi + tile - 1) // tile - lo // tile, 0)
    bucket = bb.bucket_tiles(int(n_tiles.max()), total_tiles)
    k1m = min(max(fl.kr1_for(cfg.k, cfg.folding_m), cfg.k), bb4.store.main.capacity)
    qf = fl.fold_torch(q_full, cfg.folding_m, cfg.folding_scheme)
    lo_t = torch.as_tensor(lo, dtype=torch.int32, device=dev)
    hi_t = torch.as_tensor(hi, dtype=torch.int32, device=dev)
    wlo, whi = ops.window_bounds(lo_t, hi_t, bb4.folded.shape[0], bucket, tile, dev)

    def win(qx, n_q):
        return ops.window_topk(qx, bb4.folded, bb4.folded_cnt, lo_t[:n_q],
                               hi_t[:n_q], k1m, max_tiles=bucket, tile_n=tile)

    compare("window_topk", win(qf[:64].contiguous(), 64),
            ref.window_topk_ref(qf[:64].contiguous(), bb4.folded,
                                bb4.folded_cnt, wlo[:64], whi[:64], k1m),
            "at the full shape (64 queries)")
    log(f"both kernels bit-identical to plain at the full shape (64 queries; "
        f"window k={k1m}, max_tiles={bucket}, tile={tile})")

    # -- timing ---------------------------------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk_mhz = float(smi("clocks.max.sm").split()[0])
    popc_per_s = sms * POPC_PER_CLK_PER_SM * clk_mhz * 1e6
    qn, w = q_full.shape
    n_cap = db_main.shape[0]
    kernels = []

    brute_ms, got = cuda_ms(lambda: ops.tanimoto_topk(
        q_full, db_main, cfg.k, db_popcount=cnt_main), 3)
    brute_plain, want = cuda_ms(lambda: ref.tanimoto_topk_ref(
        q_full, db_main, cfg.k, cnt_main), 1, warm=False)
    compare("tanimoto_topk", got, want, f"at the main path's shape ({qn} queries)")
    del got, want
    scores = score_matrix(q_full, db_main, cnt_main, TANIMOTO)
    brute_lib, _ = cuda_ms(lambda: torch.topk(scores, cfg.k, dim=1), 2)
    del scores
    bytes_b = n_cap * (w * 4 + 4) + qn * w * 4 + qn * cfg.k * 8
    ops_b = qn * n_cap * w
    kernels.append(dict(
        name="tanimoto_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/tanimoto_topk.cu",
        replaces="src/repro/kernels/tanimoto_topk.py:85",
        launches=launches["tanimoto_topk"],
        max_abs_err=MAX_ABS_ERR["tanimoto_topk"], ms=brute_ms,
        plain_ms=brute_plain,
        bound_ms=max(bytes_b / HBM_BYTES_PER_S, ops_b / popc_per_s) * 1e3,
        bound_by="bytes" if bytes_b / HBM_BYTES_PER_S > ops_b / popc_per_s
        else "operations",
        library_ms=brute_lib, shape=dict(Q=qn, N=n_cap, W=w, k=cfg.k)))

    wf = qf.shape[1]
    win_ms, got = cuda_ms(lambda: win(qf, qn), 3)
    win_plain, want = cuda_ms(lambda: ref.window_topk_ref(
        qf, bb4.folded, bb4.folded_cnt, wlo, whi, k1m), 1, warm=False)
    compare("window_topk", got, want, f"at the main path's shape ({qn} queries)")
    del got, want
    log(f"both kernels bit-identical to plain at the main path's shape "
        f"({qn} queries)")
    fscores = score_matrix(qf, bb4.folded, bb4.folded_cnt, TANIMOTO)
    idx = torch.arange(n_cap, device=dev)[None, :]
    for q0 in range(0, qn, 128):
        inside = (idx >= wlo[q0:q0 + 128, None]) & (idx < whi[q0:q0 + 128, None])
        fscores[q0:q0 + 128].masked_fill_(~inside, float("-inf"))
    win_lib, _ = cuda_ms(lambda: torch.topk(fscores, k1m, dim=1), 2)
    del fscores
    rows_scanned = int((whi - wlo).clamp(min=0).sum())
    union_rows = int(whi.max() - wlo.min())
    bytes_w = union_rows * (wf * 4 + 4) + qn * wf * 4 + qn * 8 + qn * k1m * 8
    ops_w = rows_scanned * wf
    kernels.append(dict(
        name="window_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/tanimoto_topk.cu",
        replaces="src/repro/kernels/tanimoto_topk.py:286",
        launches=launches["window_topk"],
        max_abs_err=MAX_ABS_ERR["window_topk"], ms=win_ms,
        plain_ms=win_plain,
        bound_ms=max(bytes_w / HBM_BYTES_PER_S, ops_w / popc_per_s) * 1e3,
        bound_by="bytes" if bytes_w / HBM_BYTES_PER_S > ops_w / popc_per_s
        else "operations",
        library_ms=win_lib,
        shape=dict(Q=qn, N=n_cap, W=wf, k=k1m, max_tiles=bucket, tile=tile,
                   rows_scanned=rows_scanned)))
    for kern in kernels:
        log(f"{kern['name']}: {kern['ms']:.3f} ms (bound {kern['bound_ms']:.3f} "
            f"ms by {kern['bound_by']}), plain {kern['plain_ms']:.1f} ms, "
            f"torch.topk {kern['library_ms']:.3f} ms, "
            f"{kern['launches']} launches on the main path")

    record.update(kernels=kernels, smi=smi_line, sm_clock_max_mhz=clk_mhz,
                  sms=sms, power_limit=smi("power.limit"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    line = [{k: v for k, v in kern.items() if k != "shape"} for kern in kernels]
    check(all(math.isfinite(kern["ms"]) for kern in kernels), "non-finite time")
    print(json.dumps({"kernels": line}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except (SmokeFailure, ImportError) as exc:
        print(f"[chip-smoke] FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
