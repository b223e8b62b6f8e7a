"""Smoke run of redisson_tpu_torch on one CUDA card.

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, then drives
the main path through the public client at full size:

  phase 0  device, nvidia-smi name and power limit, kernel build
  phase 1  kernel K1 (csrc/cms_seq.cu) vs its plain version and golden_seq,
           bit for bit, at d=5, w=65536, B=32768 and at the edge shapes of
           K1_EDGES; kernel and plain times for zipf(1.2), uniform and
           one-key streams at the main shape, and the bound
  phase 2  RBloomFilter at 1M keys / 1% FPP: add_all_async, contains_many,
           contains_each; the tenant row vs the golden bitmap; measured FPP
           vs the expected rate for the 2**20 keys loaded
  phase 3  1000 tenants, mixed add/contains/mixed runs from 4 threads
           through the coalescer; every per-op result vs the golden model
  phase 4  RCountMinSketch(5, 65536) add_all_seq over 2M zipf(1.2) events;
           table vs golden, first chunk vs golden_seq, top-10 recall, K1
           launches
  phase 5  config 2, RHyperLogLog PFADD: a 2**21-key warm-up, then 4
           disjoint batches of 2**21 keys issued together and resolved
           with collect (10,485,760 distinct keys); registers vs the golden
           model, count() vs its Ertl estimate and within 5% of the truth,
           per-op changed flags of a 2**16-key chunk with repeats vs the
           sequential model; PFADD ops/s and count() latency
  phase 6  config 3, RBitSet of 2**30 bits: set(2**30 - 1), then 8
           alternating set_many_async / get_many_async of 2**21 uniform
           indexes resolved with collect; every per-op result, the final
           row, cardinality() and length() vs a numpy bitmap updated in
           order; ops/s
  phase 7  4 threads, each owning 16 bitsets and 16 HLLs, issue random
           SET/CLEAR/FLIP/GET batches and PFADDs through the coalescer (one
           burst of more than 1024 runs, one of fewer); every per-op result
           vs each tenant's sequential model

Every failed check raises, so the script exits non-zero.  Without a CUDA
device it exits with code 2 before printing any result.  The line before
the last is nvidia-smi's name and power limit; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N] [--parent-k1 SOURCE]

``--parent-k1`` builds another version of ``csrc/cms_seq.cu`` (one with
the launch interface of the one-warp-per-row kernel) and times it beside
K1 in turns: parent, K1, K1, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 rate of one H100 SXM (NVIDIA data sheet)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls queued behind a
    sleep kernel, so that the host's time to enqueue them is hidden (a call
    of K1's wrapper costs the host more than the kernel costs the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
        check(cycles <= 1 << 34, "the host never got ahead of the card")


def zipf_keys(rng, n: int, n_keys: int = 100_000) -> np.ndarray:
    return (rng.zipf(1.2, size=n) % n_keys).astype(np.uint64)


# -- phase 1: K1 against its plain version -----------------------------------

# Shapes K1 is held at besides the main path's: (name, d, w, B, stream,
# pool words before the table).
K1_EDGES = [
    ("one_op", 5, 1 << 16, 1, "zipf", 0),
    ("33_ops", 5, 1 << 16, 33, "zipf", 0),
    ("ragged_last_tile", 3, 10_007, 5000, "zipf", 0),
    ("one_key", 5, 1 << 16, 1 << 15, "one_key", 0),
    ("uniform", 5, 1 << 16, 1 << 15, "uniform", 0),
    ("weights_wrap", 5, 1 << 16, 1 << 15, "wrap", 0),
    ("pool_view", 5, 1 << 16, 1 << 15, "zipf", 5 * (1 << 16) * 4 + 128),
    ("8_mib", 2, 1 << 20, 1 << 15, "zipf", 0),
]


def k1_inputs(rng, d: int, w: int, B: int, stream: str):
    """Murmur-hashed op columns of a key stream, weights and a table."""
    from redisson_tpu_torch.utils import hashing

    if stream == "one_key":
        keys = np.full(B, 12345, np.uint64)
    elif stream == "uniform":
        keys = rng.integers(0, 1 << 40, B).astype(np.uint64)
    else:
        keys = zipf_keys(rng, B)
    blocks, lengths = hashing.encode_uint64_batch(keys)
    h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(blocks, lengths), w)
    wt = (rng.random(B) < 0.9).astype(np.uint32)  # weight 1, some 0 (pure estimates)
    table = rng.integers(0, 1 << 16, d * w).astype(np.uint32)
    if stream == "wrap":  # counters and weights past 2**31: unsigned wrap and min
        wt = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        table = rng.integers(0, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    return table, h1w, h2w, wt


def k1_check(rng, dev, d, w, B, stream, before_words) -> int:
    """K1 vs its plain version and golden_seq on one shape, the table a view
    into a pool whose other words must not change.  Returns the max abs
    error (0, or the check fails)."""
    from redisson_tpu_torch.ops import cms_seq

    table0, h1w, h2w, wt = k1_inputs(rng, d, w, B, stream)
    pool = rng.integers(0, 1 << 32, before_words + d * w + 96, dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[before_words : before_words + d * w] = table0
    view = slice(before_words, before_words + d * w)

    def cols():
        return [torch.from_numpy(a.view(np.int32).copy()).to(dev)
                for a in (pool, h1w, h2w, wt)]

    k_pool, *k_ops = cols()
    k_est = cms_seq.cms_update_estimate_seq(k_pool[view], *k_ops, d=d, w=w)
    p_pool, *p_ops = cols()
    p_est = cms_seq.cms_seq_plain(p_pool[view], *p_ops, d=d, w=w)
    torch.cuda.synchronize()
    err = max(int((k_pool.long() - p_pool.long()).abs().max()),
              int((k_est.long() - p_est.long()).abs().max()))
    check(torch.equal(k_pool, p_pool) and torch.equal(k_est, p_est),
          f"K1 disagrees with its plain version at d={d} w={w} B={B} {stream} "
          f"(max abs err {err})")
    with np.errstate(over="ignore"):  # golden_seq wraps mod 2**32
        g_table, g_est = cms_seq.golden_seq(table0.reshape(d, w), h1w, h2w, wt, d=d, w=w)
    k_pool = k_pool.cpu().numpy().view(np.uint32)
    check(np.array_equal(k_pool[view], g_table.reshape(-1))
          and np.array_equal(k_est.cpu().numpy().view(np.uint32), g_est),
          f"K1 disagrees with golden_seq at d={d} w={w} B={B} {stream}")
    return err


def load_parent_k1(source: str):
    """An earlier K1 with the one-warp-per-row launch interface, built from
    a copy of its source, for timing beside the current kernel.  Returns
    launch(table, h1, h2, wt, d=, w=)."""
    import ctypes
    from pathlib import Path

    from redisson_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "parent_cms_seq.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(Path(source).resolve())], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cms_seq_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.cms_seq_launch.restype = i

    def launch(table, h1, h2, wt, *, d, w):
        est = torch.full((h1.shape[0],), -1, dtype=torch.int32, device=table.device)
        rc = lib.cms_seq_launch(table.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                                wt.data_ptr(), est.data_ptr(), h1.shape[0], d, w,
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K1 launch failed: CUDA error {rc}")
        return est

    return launch


def phase_k1(rng, dev, parent_source=None) -> dict:
    from redisson_tpu_torch.ops import cms_seq

    d, w, B = 5, 1 << 16, 1 << 15
    err = k1_check(rng, dev, d, w, B, "zipf", 0)
    for _, *shape in K1_EDGES:
        err = max(err, k1_check(rng, dev, *shape))
    parent = load_parent_k1(parent_source) if parent_source else None

    ms, plain_ms, parent_ms, call_ms = {}, {}, {}, None
    for stream in ("zipf", "uniform", "one_key"):
        cols = [torch.from_numpy(a.view(np.int32).copy()).to(dev)
                for a in k1_inputs(rng, d, w, B, stream)]

        def new():
            return cms_seq.cms_update_estimate_seq(*cols, d=d, w=w)

        if parent is None:
            ms[stream] = device_time_ms(new, 50)
        else:  # in turns: parent, new, new, parent
            t = [device_time_ms(f, 50) for f in (lambda: parent(*cols, d=d, w=w),
                                               new, new,
                                               lambda: parent(*cols, d=d, w=w))]
            ms[stream], parent_ms[stream] = t[1:3], [t[0], t[3]]
            check(torch.equal(parent(*[c.clone() for c in cols], d=d, w=w),
                              cms_seq.cms_update_estimate_seq(
                                  *[c.clone() for c in cols], d=d, w=w)),
                  f"parent K1 and K1 disagree on the {stream} stream")
        plain_ms[stream] = cuda_time_ms(
            lambda: cms_seq.cms_seq_plain(*cols, d=d, w=w), 20)
        if stream == "zipf":  # back-to-back calls, paced by the host
            call_ms = cuda_time_ms(new, 50)
    # Least time for the same work: the table read and written once, the
    # three op columns read once, the estimates written once.
    nbytes = 2 * d * w * 4 + 3 * B * 4 + B * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    zipf_ms = ms["zipf"] if parent is None else sum(ms["zipf"]) / 2
    log({"phase": 1, "kernel": "cms_seq", "d": d, "w": w, "B": B,
         "plan": cms_seq._plan(d, w, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)._asdict(),
         "edge_shapes": [e[0] for e in K1_EDGES],
         "bit_identical_to_plain": True, "matches_golden_seq": True,
         "ms_by_stream": ms, "parent_ms_by_stream": parent_ms or None,
         "plain_ms_by_stream": plain_ms, "host_paced_call_ms": call_ms,
         "bound_ms": bound_ms,
         "bytes": nbytes, "compare_launches": cms_seq.LAUNCHES})
    return {"name": "cms_seq", "route": "cuda",
            "source": "redisson_tpu_torch/csrc/cms_seq.cu",
            "replaces": "redisson_tpu/ops/pallas_cms.py:123",
            "max_abs_err": err, "ms": zipf_ms, "ms_by_stream": ms,
            "plain_ms": plain_ms["zipf"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


# -- phase 2: config 1, Bloom at 1M keys / 1% FPP -----------------------------


def golden_bloom(bf, keys: np.ndarray):
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    m, k = bf.get_size(), bf.get_hash_iterations()
    g = golden.GoldenBloomFilter(m, k)
    h1m, h2m = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(keys)), m)
    g.bits[g._indexes(h1m, h2m).reshape(-1)] = True  # setting bits is order-free
    return g


def golden_contains(g, keys: np.ndarray) -> np.ndarray:
    from redisson_tpu_torch.utils import hashing

    h1m, h2m = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), g.size)
    return g.contains_hashed(h1m, h2m)


def tenant_row(client, name: str) -> np.ndarray:
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    return eng.executor.read_row(e.pool, e.row)


def phase_bloom(client, rng, card: str) -> None:
    bf = client.get_bloom_filter("cfg1")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    n_load, chunk = 1 << 20, 1 << 18
    # Warm-up on a filter of the same size class, so the timed adds do not
    # pay the process's first CUDA launches of each op.
    warm = client.get_bloom_filter("cfg1-warmup")
    check(warm.try_init(1_000_000, 0.01), "try_init refused")
    warm.add_all_async(np.arange(chunk, dtype=np.uint64)).result()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adds = [bf.add_all_async(np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64))
            for i in range(n_load // chunk)]
    n_added = sum(int(np.sum(a.result())) for a in adds)
    add_s = time.perf_counter() - t0
    check(0.97 * n_load <= n_added <= n_load, f"added {n_added} of {n_load}")

    g = golden_bloom(bf, np.arange(n_load, dtype=np.uint64))
    words = tenant_row(client, "cfg1")
    gbits = np.zeros(words.shape[0] * 32, bool)
    gbits[: g.size] = g.bits
    check(np.array_equal(words, np.packbits(gbits, bitorder="little").view(np.uint32)),
          "bloom tenant row differs from the golden bitmap")

    batches = [rng.integers(0, 2 * n_load, 1 << 20).astype(np.uint64) for _ in range(4)]
    bf.contains_many(batches[:1])  # warm-up pass
    t0 = time.perf_counter()
    hits = bf.contains_many(batches)
    contains_s = time.perf_counter() - t0
    for b, h in zip(batches, hits):
        check(np.array_equal(h, golden_contains(g, b)), "contains differs from golden")
    outside = rng.integers(3 * n_load, 8 * n_load, 1 << 17).astype(np.uint64)
    fp = bf.contains_each(outside)
    check(np.array_equal(fp, golden_contains(g, outside)), "contains_each differs from golden")
    fpp = float(fp.mean())
    # The load is 2**20 keys, 4.9% past the design point of 1M, so the
    # expected rate is (1 - e^(-k n / m))^k = 1.26%, not 1%.  The measured
    # rate must sit within 3 binomial sigmas of it (and equals the golden
    # model's exactly, checked above).
    m, k = bf.get_size(), bf.get_hash_iterations()
    p_theory = (1.0 - np.exp(-k * n_load / m)) ** k
    sigma = np.sqrt(p_theory * (1.0 - p_theory) / len(outside))
    check(abs(fpp - p_theory) <= 3 * sigma,
          f"measured FPP {fpp} vs expected {p_theory} +- {3 * sigma}")
    log({"phase": 2, "config": "bloom 1M keys 1% FPP", "added": n_added,
         "add_ops_per_s": n_load / add_s,
         "contains_ops_per_s": sum(map(len, batches)) / contains_s,
         "fpp": fpp, "fpp_expected": p_theory, "fpp_3sigma": 3 * sigma,
         "row_equals_golden": True, "card": card})


# -- phase 3: multi-tenant coalesced runs -------------------------------------


def phase_tenants(client, rng) -> None:
    from redisson_tpu_torch.ops import golden

    n_tenants, n_threads, per_op = 1000, 4, 256
    names = [f"t{i}" for i in range(n_tenants)]
    for name in names:
        check(client.get_bloom_filter(name).try_init(10_000, 0.01), "try_init refused")
    plans = {
        name: [(kind, rng.integers(0, 4000, per_op).astype(np.uint64),
                rng.random(per_op) < 0.5)
               for kind in ("add", "contains", "mixed", "add", "contains")]
        for name in names
    }
    ex = client._engine.executor
    runs_per_flush = []
    orig = ex.bloom_mixed_keys_runs

    def spy(pool, k, blocks, lengths, run_rows, *rest):
        runs_per_flush.append(len(run_rows))
        return orig(pool, k, blocks, lengths, run_rows, *rest)

    ex.bloom_mixed_keys_runs = spy
    results: dict = {}

    def worker(t):
        mine = names[t::n_threads]
        futs = {}
        for step in range(5):  # each tenant's ops are issued in order
            for name in mine:
                bf = client.get_bloom_filter(name)
                kind, keys, flags = plans[name][step]
                if kind == "add":
                    f = bf.add_all_async(keys)
                elif kind == "contains":
                    f = bf.contains_all_async(keys)
                else:
                    f = bf.mixed_async(keys, flags)
                futs.setdefault(name, []).append(f)
        for name, fs in futs.items():
            results[name] = [f.result() for f in fs]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "tenant workers hung")
    wall_s = time.perf_counter() - t0
    del ex.bloom_mixed_keys_runs
    check(max(runs_per_flush) > 1, "no flush carried more than one run")

    from redisson_tpu_torch.utils import hashing

    bf0 = client.get_bloom_filter(names[0])
    m, k = bf0.get_size(), bf0.get_hash_iterations()
    for name in names:
        g = golden.GoldenBloomFilter(m, k)
        for (kind, keys, flags), got in zip(plans[name], results[name]):
            h1m, h2m = hashing.km_reduce_mod(
                *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), m)
            if kind == "add":
                want = g.add_hashed(h1m, h2m)
            elif kind == "contains":
                want = g.contains_hashed(h1m, h2m)
            else:  # one op at a time, in order
                want = np.array([
                    g.add_hashed(h1m[i:i + 1], h2m[i:i + 1])[0] if f
                    else g.contains_hashed(h1m[i:i + 1], h2m[i:i + 1])[0]
                    for i, f in enumerate(flags)
                ])
            check(np.array_equal(got, want), f"tenant {name} {kind} differs from golden")
    log({"phase": 3, "tenants": n_tenants, "threads": n_threads,
         "ops": n_tenants * 5 * per_op, "ops_per_s": n_tenants * 5 * per_op / wall_s,
         "flushes": len(runs_per_flush), "max_runs_per_flush": max(runs_per_flush),
         "results_equal_golden": True})


# -- phase 4: config 5, CMS streaming top-K -----------------------------------


def phase_cms(client, rng, card: str) -> None:
    from redisson_tpu_torch.ops import cms_seq, golden
    from redisson_tpu_torch.utils import hashing

    d, w, n_events = 5, 1 << 16, 2_000_000
    cms = client.get_count_min_sketch("cms")
    check(cms.try_init(d, w, track_top_k=20), "try_init refused")
    events = zipf_keys(rng, n_events)
    before = cms_seq.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = cms.add_all_seq(events)
    dt = time.perf_counter() - t0
    launches = cms_seq.LAUNCHES - before
    chunk = client._engine._SEQ_CHUNK
    check(launches == -(-n_events // chunk), f"{launches} K1 launches")

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
    g = golden.GoldenCountMinSketch(d, w)
    g.add_hashed(h1w, h2w)
    row = tenant_row(client, "cms")
    check(np.array_equal(row[: d * w].reshape(d, w), g.counts), "CMS table differs from golden")
    _, g_est = cms_seq.golden_seq(np.zeros((d, w), np.uint32), h1w[:chunk], h2w[:chunk],
                                  np.ones(chunk, np.uint32), d=d, w=w)
    check(np.array_equal(est[:chunk], g_est), "first chunk differs from golden_seq")
    true_top = set(np.argsort(-np.bincount(events.astype(np.int64)))[:10].tolist())
    got = {int(key) for key, _ in cms.top_k(10)}
    recall = len(got & true_top) / 10.0
    check(recall == 1.0, f"top-10 recall {recall}")
    check(cms.total_count() == n_events, "total count")
    log({"phase": 4, "config": "cms 5x65536 streaming top-K", "events": n_events,
         "events_per_s": n_events / dt, "k1_launches": launches,
         "table_equals_golden": True, "first_chunk_equals_golden_seq": True,
         "top10_recall": recall, "card": card})


# -- phase 5: config 2, HyperLogLog PFADD at 10M cardinality ------------------


def hll_lanes(keys: np.ndarray):
    """Host murmur lanes (c0, c1, c2) of LongCodec-encoded keys."""
    from redisson_tpu_torch.utils import hashing

    return hashing.murmur3_x86_128(*hashing.encode_uint64_batch(keys))[:3]


def golden_hll_changed(regs: np.ndarray, c0, c1, c2) -> np.ndarray:
    """One op at a time: op j changed iff its rank beat its register.
    Updates ``regs`` in place."""
    from redisson_tpu_torch.ops import golden

    idx, rank = golden.hll_index_rank(c0, c1, c2)
    out = np.zeros(len(c0), bool)
    for j, (i, r) in enumerate(zip(idx.tolist(), rank.tolist())):
        if r > regs[i]:
            out[j] = True
            regs[i] = r
    return out


def phase_hll(client, rng, card: str) -> None:
    from redisson_tpu_torch.ops import golden

    B, iters = 1 << 21, 4
    h = client.get_hyper_log_log("cfg2")
    check(h.add_all_async(np.arange(B, dtype=np.uint64)).result(), "warm-up changed nothing")
    batches = [np.arange((i + 1) * B, (i + 2) * B, dtype=np.uint64) for i in range(iters)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [h.add_all_async(b) for b in batches]
    changed = client.collect(futs)
    add_s = time.perf_counter() - t0
    check(all(changed), f"a PFADD batch of new keys changed nothing: {changed}")
    n = (iters + 1) * B
    t0 = time.perf_counter()
    est = h.count()
    count_ms = (time.perf_counter() - t0) * 1e3

    g = golden.GoldenHyperLogLog()
    for i in range(iters + 1):
        g.add_hashed(*hll_lanes(np.arange(i * B, (i + 1) * B, dtype=np.uint64)))
    regs = tenant_row(client, "cfg2")
    check(np.array_equal(regs, g.regs), "HLL registers differ from the golden model")
    want = int(round(golden.ertl_estimate(np.bincount(regs, minlength=golden.HLL_Q + 2))))
    check(est == want == g.count(), f"count() {est} vs Ertl {want}")
    check(abs(est - n) / n < 0.05, f"count() {est} vs {n} distinct keys")

    # Per-op flags: a chunk with repeats on a tenant already holding keys.
    f = client.get_hyper_log_log("cfg2-flags")
    f.add_all(np.arange(1 << 15, dtype=np.uint64))
    chunk = rng.integers(0, 1 << 17, 1 << 16).astype(np.uint64)
    eng = client._engine
    e = eng.registry.lookup("cfg2-flags")
    g_regs = tenant_row(client, "cfg2-flags")
    c0, c1, c2 = hll_lanes(chunk)
    flags = eng.executor.hll_add_changed(
        e.pool, np.full(len(chunk), e.row, np.int32), c0, c1, c2).result()
    want_flags = golden_hll_changed(g_regs, c0, c1, c2)
    check(np.array_equal(flags, want_flags), "per-op changed flags differ from golden")
    check(np.array_equal(tenant_row(client, "cfg2-flags"), g_regs), "flag chunk registers differ")
    check(0 < want_flags.sum() < len(chunk), "the flag chunk does not exercise both outcomes")
    log({"phase": 5, "config": "hll pfadd 10M cardinality", "keys": n,
         "pfadd_ops_per_s": iters * B / add_s, "count": est,
         "count_rel_err": (est - n) / n, "count_ms": count_ms,
         "registers_equal_golden": True, "flag_chunk_ops": len(chunk),
         "flag_chunk_changed": int(want_flags.sum()), "flags_equal_golden": True,
         "card": card})


# -- phase 6: config 3, a 2**30-bit BitSet -------------------------------------

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def golden_set(bitmap: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """SETBIT of a batch on a uint32 word bitmap, one op at a time: the
    previous bit per op (1 after an earlier set of the same index)."""
    w, b = idx >> 5, (idx & 31).astype(np.uint32)
    prev = ((bitmap[w] >> b) & 1).astype(bool)
    first = np.zeros(len(idx), bool)
    first[np.unique(idx, return_index=True)[1]] = True
    np.bitwise_or.at(bitmap, w, np.uint32(1) << b)
    return prev | ~first


def golden_get(bitmap: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return ((bitmap[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1).astype(bool)


def phase_bitset(client, rng, card: str) -> None:
    nbits, B, iters = 1 << 30, 1 << 21, 8
    bitmap = np.zeros(nbits // 32, np.uint32)
    bs = client.get_bit_set("cfg3")
    check(not bs.set(nbits - 1), "set(2**30 - 1) found the bit set")
    golden_set(bitmap, np.array([nbits - 1]))
    check(bs.size() == nbits, f"size {bs.size()}")
    # Warm-up: the first launches of each op at this batch size.
    warm = rng.integers(0, nbits, B).astype(np.uint32)
    check(np.array_equal(bs.set_many(warm), golden_set(bitmap, warm)), "warm-up set differs")
    warm = rng.integers(0, nbits, B).astype(np.uint32)
    check(np.array_equal(bs.get_many(warm), golden_get(bitmap, warm)), "warm-up get differs")
    idxs = [rng.integers(0, nbits, B).astype(np.uint32) for _ in range(iters)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [bs.set_many_async(idx) if i % 2 == 0 else bs.get_many_async(idx)
                for i, idx in enumerate(idxs)]
    res = client.collect(futs)
    dt = time.perf_counter() - t0
    for i, (idx, got) in enumerate(zip(idxs, res)):
        want = golden_set(bitmap, idx) if i % 2 == 0 else golden_get(bitmap, idx)
        check(np.array_equal(got, want), f"batch {i} differs from the golden bitmap")
    check(np.array_equal(tenant_row(client, "cfg3"), bitmap), "row differs from the golden bitmap")
    card_want = int(_POPCOUNT8[bitmap.view(np.uint8)].sum(dtype=np.int64))
    last = int(np.flatnonzero(bitmap)[-1])
    length_want = last * 32 + int(bitmap[last]).bit_length()
    check(bs.cardinality() == card_want, f"cardinality {bs.cardinality()} vs {card_want}")
    check(bs.length() == length_want == nbits, f"length {bs.length()} vs {length_want}")
    log({"phase": 6, "config": "bitset 2**30 bits", "ops": iters * B,
         "ops_per_s": iters * B / dt, "cardinality": card_want,
         "results_equal_golden": True, "row_equals_golden": True, "card": card})


# -- phase 7: interleaved opcodes from 4 threads through the coalescer ------------


def phase_interleaved(rng) -> None:
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import golden

    n_threads, per_thread, nbits = 4, 16, 4096
    # A long flush window: a burst queues whole before its first flush, so
    # one launch carries every chunk of the burst as a run.
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        batch_window_us=2_000_000))
    try:
        eng = client._engine
        names = [f"p7-{i}" for i in range(n_threads * per_thread)]
        for name in names:
            eng.bitset_ensure(name, nbits)
        ex = eng.executor
        runs = {"runs": [], "per_op": []}
        orig_runs, orig_ops = ex.bitset_mixed_runs, ex.bitset_mixed

        def spy_runs(pool, idx, run_rows, *rest):
            runs["runs"].append(len(run_rows))
            return orig_runs(pool, idx, run_rows, *rest)

        def spy_ops(pool, rows, *rest):
            runs["per_op"].append(len(rows))
            return orig_ops(pool, rows, *rest)

        ex.bitset_mixed_runs, ex.bitset_mixed = spy_runs, spy_ops
        plans = {}  # name -> [(kind, idx or keys)] per burst
        for burst_rounds in (24, 4):
            for name in names:
                plans.setdefault(name, []).append([
                    (int(rng.integers(0, 5)),
                     rng.integers(0, nbits, int(rng.integers(1, 48))).astype(np.uint32))
                    for _ in range(burst_rounds)])
        results: dict = {}
        barrier = threading.Barrier(n_threads)

        def worker(t):
            mine = names[t * per_thread : (t + 1) * per_thread]
            for burst in range(2):
                futs = {name: [] for name in mine}
                for step in range(len(plans[mine[0]][burst])):
                    for name in mine:
                        kind, idx = plans[name][burst][step]
                        if kind == 0:
                            f = eng.bitset_set(name, idx, True)
                        elif kind == 1:
                            f = eng.bitset_set(name, idx, False)
                        elif kind == 2:
                            f = eng.bitset_flip(name, idx)
                        elif kind == 3:
                            f = eng.bitset_get(name, idx)
                        else:
                            f = client.get_hyper_log_log("h" + name).add_all_async(
                                idx.astype(np.uint64))
                        futs[name].append(f)
                barrier.wait(timeout=600)  # the burst is queued whole
                for name in mine:
                    results.setdefault(name, []).extend(f.result() for f in futs[name])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        check(not any(th.is_alive() for th in threads), "phase 7 workers hung")
        wall_s = time.perf_counter() - t0
        del ex.bitset_mixed_runs, ex.bitset_mixed
        n_ops = 0
        for name in names:
            bits = np.zeros(nbits, bool)
            regs = golden.GoldenHyperLogLog()
            ops = [op for burst in plans[name] for op in burst]
            for (kind, idx), got in zip(ops, results[name]):
                n_ops += len(idx)
                if kind == 4:
                    before = regs.regs.copy()
                    regs.add_hashed(*hll_lanes(idx.astype(np.uint64)))
                    check(got == bool(np.any(regs.regs != before)), f"{name} PFADD differs")
                    continue
                want = np.empty(len(idx), bool)
                for j, i in enumerate(idx):
                    want[j] = bits[i]
                    if kind < 3:
                        bits[i] = (kind == 0) if kind < 2 else not bits[i]
                check(np.array_equal(got, want), f"{name} opcode {kind} differs from golden")
            check(np.array_equal(tenant_row(client, name),
                                 np.packbits(bits, bitorder="little").view(np.uint32)),
                  f"{name} row differs from golden")
        check(max(runs["per_op"], default=0) > 1024, f"no flush of more than 1024 runs: {runs}")
        check(max(runs["runs"], default=0) > 1, f"no multi-run flush: {runs}")
        log({"phase": 7, "threads": n_threads, "bitsets": len(names), "ops": n_ops,
             "ops_per_s": n_ops / wall_s, "runs_flushes": runs["runs"],
             "per_op_flush_ops": runs["per_op"], "results_equal_golden": True})
    finally:
        client.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-k1", metavar="SOURCE",
                    help="a K1 source with the one-warp-per-row interface, timed beside K1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import _build, cms_seq

    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi()
    build_s = _build.build(["cms_seq"])
    ptxas = _build.BUILD_LOG.get("cms_seq", "")
    log({"phase": 0, "device": name, "count": count, "nvidia_smi": card,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": [  # registers, shared memory, spills
             line.split("ptxas info    : ")[-1] for line in ptxas.splitlines()
             if "registers" in line or "spill" in line or "Compiling" in line]})
    rng = np.random.default_rng(args.seed)
    kernel = phase_k1(rng, dev, args.parent_k1)

    # LongCodec: integer keys take the vectorized 8-byte encoding, as in
    # the JAX package's benchmark configs.
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch())
    try:
        cms_seq.LAUNCHES = 0  # count the main path's launches only
        phase_bloom(client, rng, card)
        phase_tenants(client, rng)
        phase_cms(client, rng, card)
        kernel["launches"] = cms_seq.LAUNCHES
        check(kernel["launches"] > 0, "the main path never launched K1")
        phase_hll(client, rng, card)
        phase_bitset(client, rng, card)
    finally:
        client.shutdown()
    phase_interleaved(rng)
    log({"kernels": [kernel]})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
