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
  phase 8  the RObject lifecycle on the phases 2-6 keyspace (about 0.55 GiB
           of pools): Bloom count() vs the golden bitmap's; DUMP/RESTORE of
           the four config-sized objects (rows equal on the card, re-dumps
           equal, BUSYKEY); CMS merge (numpy uint32 sum, wrapping) and
           reset; rename; a TTL reaped within 5 s and its row zeroed; one
           batch of 326 sync-named calls vs direct calls on twins, with
           fewer dispatches than calls; a whole-keyspace snapshot restored
           on create by a second client (every pool byte-equal, equal
           answers), then 2**18 events through add_all_seq on both CMSes
           (K1 launches on the restored one; equal tables)

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
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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


def phase_bloom(client, rng, card: str):
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
    return g


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


# -- phase 8: the keyspace lifecycle at full size ----------------------------------

_GETTERS = {"bloom": "get_bloom_filter", "hll": "get_hyper_log_log",
            "bitset": "get_bit_set", "cms": "get_count_min_sketch"}
# Executor methods that launch a coalesced segment: the batch's dispatches.
_DISPATCHES = ("bloom_mixed_keys_runs", "bloom_mixed_keys", "hll_add_changed",
               "cms_update_estimate", "cms_estimate", "bitset_mixed_runs", "bitset_mixed")


def row_view(client, name: str):
    """The tenant row of ``name`` as a view of its pool on the card."""
    from redisson_tpu_torch.ops import bitops

    e = client._engine.registry.lookup(name)
    return bitops.row_slice(e.pool.state, e.row, e.pool.row_units)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lifecycle_dump_restore(client) -> dict:
    """DUMP each config-sized object, RESTORE it under a new name: rows
    equal on the card, the re-dump equal to the dump, BUSYKEY refused."""
    times = {}
    for kind, name in (("bloom", "cfg1"), ("cms", "cms"), ("hll", "cfg2"), ("bitset", "cfg3")):
        get = getattr(client, _GETTERS[kind])
        blob, dump_s = timed(get(name).dump)
        restored = get(name + "-r")
        _, restore_s = timed(lambda: restored.restore(blob))
        check(torch.equal(row_view(client, name), row_view(client, name + "-r")),
              f"restored {kind} row differs from {name}'s on the card")
        check(restored.dump() == blob, f"re-dump of the restored {kind} differs")
        try:
            restored.restore(blob)
        except ValueError as e:
            check("BUSYKEY" in str(e), f"restore onto {name}-r: {e}")
        else:
            fail(f"restore onto the existing {name}-r without replace succeeded")
        times[kind] = {"bytes": len(blob), "dump_s": dump_s, "restore_s": restore_s}
    # The card's share of a dump: one D2H of the row.
    e = client._engine.registry.lookup("cfg3")
    _, times["bitset"]["row_d2h_s"] = timed(lambda: client._engine.executor.read_row(e.pool, e.row))
    return times


def lifecycle_cms(client, rng) -> None:
    """Merge a second zipf-fed CMS and, twice, one with every counter past
    2**31 into the restored copy (the row must equal the numpy uint32 sum,
    which wraps in every cell), then reset it (zero row, top-K
    configuration kept)."""
    from redisson_tpu_torch.interop import load_sketch_rows

    eng = client._engine
    d, w = 5, 1 << 16
    other = client.get_count_min_sketch("cms-b")
    check(other.try_init(d, w), "try_init refused")
    other.add_all(zipf_keys(rng, 1 << 20, n_keys=50_000))
    wrap = rng.integers(1 << 31, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    load_sketch_rows(client, "cms-wrap", "cms", {"depth": d, "width": w}, wrap)
    want = tenant_row(client, "cms-r")
    with np.errstate(over="ignore"):
        want += tenant_row(client, "cms-b")
        want += tenant_row(client, "cms-wrap")
        want += tenant_row(client, "cms-wrap")
    client.get_count_min_sketch("cms-r").merge("cms-b", "cms-wrap", "cms-wrap")
    got = tenant_row(client, "cms-r")
    check(np.array_equal(got, want), "merged CMS row differs from the numpy uint32 sum")
    check((got[: d * w] < wrap).mean() > 0.99, "the merge did not wrap past 2**32")
    k = eng.topk.track("cms-r")
    eng.cms_reset("cms-r")
    check(not row_view(client, "cms-r").any(), "reset left counters")
    check(k == 20 and eng.topk.track("cms-r") == k, "reset lost the top-K configuration")


def lifecycle_rename_ttl(client, n_load: int) -> float:
    """Rename the restored Bloom and expire the restored HLL; returns the
    seconds from expire(0.5) until is_exists() turned False."""
    bf = client.get_bloom_filter("cfg1-r")
    bf.rename("cfg1-renamed")
    check(bf.name == "cfg1-renamed", "rename did not repoint the handle")
    check(not client.get_bloom_filter("cfg1-r").is_exists(), "the old name survived rename")
    check(bf.contains_each(np.arange(n_load, dtype=np.uint64)).all(),
          "the renamed filter lost loaded keys")
    try:
        client.get_bloom_filter("no-such-filter").rename("elsewhere")
    except RuntimeError:
        pass
    else:
        fail("rename of a missing name succeeded")
    h = client.get_hyper_log_log("cfg2-r")
    e = client._engine.registry.lookup("cfg2-r")
    pool, row = e.pool, e.row
    t0 = time.perf_counter()
    check(h.expire(0.5), "expire refused")
    while h.is_exists():
        check(time.perf_counter() - t0 < 5.0, "the expired HLL still exists after 5 s")
        time.sleep(0.01)
    gone_s = time.perf_counter() - t0
    from redisson_tpu_torch.ops import bitops

    check(not bitops.row_slice(pool.state, row, pool.row_units).any(),
          "the expired HLL's row is not zero on the card")
    return gone_s


def cms_disjoint_keys(candidates: np.ndarray, n: int, d: int, w: int, used: set) -> np.ndarray:
    """The first ``n`` candidates whose d cells share no cell with each
    other or with ``used`` (updated in place)."""
    from redisson_tpu_torch.utils import hashing

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(candidates)), w)
    r = np.arange(d, dtype=np.uint64)
    cells = (h1w[:, None].astype(np.uint64) + r * h2w[:, None]) % np.uint64(w) + r * np.uint64(w)
    out = []
    for key, c in zip(candidates, cells.tolist()):
        if used.isdisjoint(c):
            used.update(c)
            out.append(key)
            if len(out) == n:
                return np.array(out, np.uint64)
    fail(f"only {len(out)} of {n} CMS keys with disjoint cells")


def lifecycle_batch(client, rng) -> dict:
    """One batch of sync-named calls over the four kinds against the same
    calls made directly on twin objects (both restored from one dump).
    A coalesced CMS launch returns batch-final estimates, so the batch's
    CMS keys (added once each, or only estimated) share no cell: then
    batch-final and one-call-at-a-time estimates are equal."""
    eng = client._engine
    sources = {"bloom": "cfg1", "hll": "cfg2", "cms": "cms", "bitset": "cfg3"}
    objs = {tag: {kind: f"b8-{kind}-{tag}" for kind in sources} for tag in ("batch", "twin")}
    for kind, src in sources.items():
        get = getattr(client, _GETTERS[kind])
        blob = get(src).dump()
        for tag in objs:
            get(objs[tag][kind]).restore(blob)
    used: set = set()
    cms_keys = cms_disjoint_keys(
        rng.integers(0, 1 << 40, 20_000).astype(np.uint64), 1180, 5, 1 << 16, used)
    cms_add, cms_est = cms_keys[:40], cms_keys[40:80]
    calls = []
    for i in range(40):
        key = int(rng.integers(1 << 40, 1 << 41))
        calls += [("bloom", "add", (key,)), ("bloom", "contains", (key,)),
                  ("bloom", "contains", (key + 1,)), ("hll", "add", (key,)),
                  ("cms", "add", (int(cms_add[i]), 3)), ("cms", "estimate", (int(cms_est[i]),)),
                  ("bitset", "set_many", (rng.integers(0, 1 << 30, 8).astype(np.uint32),)),
                  ("bitset", "get_many", (rng.integers(0, 1 << 30, 8).astype(np.uint32),))]
    keys = rng.integers(1 << 40, 1 << 41, 1000).astype(np.uint64)
    calls += [("bloom", "add_all", (keys[:500],)), ("bloom", "contains_all", (keys,)),
              ("bloom", "contains_each", (keys,)), ("hll", "add_all", (keys,)),
              ("cms", "add_all", (cms_keys[80:180],)),
              ("cms", "estimate_all", (cms_keys[180:],))]
    batch = client.create_batch()
    proxies = {k: getattr(batch, _GETTERS[k])(n) for k, n in objs["batch"].items()}
    for kind, meth, args in calls:
        getattr(proxies[kind], meth)(*args)
    ex = eng.executor
    dispatches = []

    def spy(name):
        orig = getattr(ex, name)

        def counted(*a, **kw):
            dispatches.append(name)
            return orig(*a, **kw)

        return counted

    for name in _DISPATCHES:
        setattr(ex, name, spy(name))
    try:
        res, execute_s = timed(lambda: batch.execute().get_responses())
    finally:
        for name in _DISPATCHES:
            delattr(ex, name)
    twins = {k: getattr(client, _GETTERS[k])(n) for k, n in objs["twin"].items()}
    check(len(res) == len(calls), f"{len(res)} responses for {len(calls)} calls")
    for (kind, meth, args), got in zip(calls, res):
        want = getattr(twins[kind], meth)(*args)
        same = (np.array_equal(got, want) if isinstance(want, np.ndarray)
                else type(got) is type(want) and got == want)
        check(same, f"batch {kind}.{meth} gave {got!r}, the direct call {want!r}")
    for kind in sources:
        check(torch.equal(row_view(client, objs["batch"][kind]),
                          row_view(client, objs["twin"][kind])),
              f"batch and twin {kind} rows differ")
    check(len(dispatches) < len(calls),
          f"{len(dispatches)} dispatches for {len(calls)} queued calls")
    for tag in objs:  # not part of the snapshot that follows
        for name in objs[tag].values():
            check(eng.delete(name), f"delete {name}")
    return {"calls": len(calls), "dispatches": len(dispatches), "execute_s": execute_s}


def lifecycle_snapshot(client, rng, seed: int) -> dict:
    """Snapshot the whole keyspace, restore it on create in a second client,
    hold every pool and the answers equal, then stream the same events
    into both CMSes (K1 runs on the restored one)."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import cms_seq

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    snap_dir = tempfile.mkdtemp(prefix="phase8-snapshot-", dir=build)
    try:
        # The card's share of a snapshot: the D2H capture under the locks.
        _, capture_s = timed(client._engine._snapshot_capture)
        _, snapshot_s = timed(lambda: client.snapshot(snap_dir))
        snap_bytes = sum(os.path.getsize(os.path.join(snap_dir, f))
                         for f in os.listdir(snap_dir))
        cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch()
        cfg.snapshot_dir = snap_dir
        twin, restore_s = timed(lambda: rt.create(cfg))
        try:
            ex1, ex2 = client._engine.executor, twin._engine.executor
            pools1, pools2 = client._engine.registry.pools(), twin._engine.registry.pools()
            check([p.spec.key for p in pools1] == [p.spec.key for p in pools2],
                  "the restored client holds other pools")
            pool_bytes = 0
            for p1, p2 in zip(pools1, pools2):
                a, b = ex1.state_to_host(p1), ex2.state_to_host(p2)
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"restored pool {p1.spec.key} differs")
                pool_bytes += a.nbytes
            check(sorted(client._engine.names()) == sorted(twin._engine.names()),
                  "the restored keyspace holds other names")
            probe = np.random.default_rng(seed + 8).integers(
                1 << 22, 1 << 24, 1 << 17).astype(np.uint64)
            for c_name, kind, fn in (
                ("cfg1", "bloom", lambda o: o.contains_each(probe).tolist()),
                ("cfg1-renamed", "bloom", lambda o: o.count()),
                ("cfg2", "hll", lambda o: o.count()),
                ("cfg3", "bitset", lambda o: (o.cardinality(), o.length())),
                ("cms", "cms", lambda o: o.top_k(10)),
            ):
                a = fn(getattr(client, _GETTERS[kind])(c_name))
                b = fn(getattr(twin, _GETTERS[kind])(c_name))
                check(a == b, f"{kind} {c_name} answers differ after restore")
            events = zipf_keys(rng, 1 << 18)
            before = cms_seq.LAUNCHES
            est2 = twin.get_count_min_sketch("cms").add_all_seq(events)
            restored_launches = cms_seq.LAUNCHES - before
            check(restored_launches > 0, "K1 never launched on the restored CMS")
            est1 = client.get_count_min_sketch("cms").add_all_seq(events)
            check(np.array_equal(est1, est2), "streamed estimates differ after restore")
            check(torch.equal(row_view(client, "cms"), row_view(twin, "cms")),
                  "CMS tables differ after the same stream")
        finally:
            # Its config names the directory: shutdown writes the final snapshot.
            _, shutdown_s = timed(twin.shutdown)
        check(os.path.exists(os.path.join(snap_dir, "sketch_meta.json")),
              "no snapshot after shutdown")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    return {"snapshot_s": snapshot_s, "capture_s": capture_s,
            "snapshot_bytes": snap_bytes, "pool_bytes": pool_bytes,
            "restore_on_create_s": restore_s, "shutdown_snapshot_s": shutdown_s,
            "k1_launches_on_restored": restored_launches}


def phase_lifecycle(client, rng, g, seed: int, card: str) -> None:
    from redisson_tpu_torch.executor.torch_executor import bloom_count_from_bitcount

    n_load = 1 << 20
    count = client.get_bloom_filter("cfg1").count()
    want = bloom_count_from_bitcount(int(g.bits.sum()), g.size, g.hash_iterations)
    check(count == want, f"count() {count} vs {want} from the golden bitmap")
    check(abs(count - n_load) / n_load < 0.05, f"count() {count} vs {n_load} keys")
    dumps = lifecycle_dump_restore(client)
    lifecycle_cms(client, rng)
    ttl_s = lifecycle_rename_ttl(client, n_load)
    batch = lifecycle_batch(client, rng)
    snap = lifecycle_snapshot(client, rng, seed)
    log({"phase": 8, "bloom_count": count, "bloom_count_rel_err": (count - n_load) / n_load,
         "dump_restore": dumps, "bitset_row_dump_s": dumps["bitset"]["dump_s"],
         "bitset_row_restore_s": dumps["bitset"]["restore_s"],
         "bitset_row_d2h_s": dumps["bitset"]["row_d2h_s"], "ttl_gone_s": ttl_s,
         "batch": batch, **snap, "card": card})


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
        g = phase_bloom(client, rng, card)
        phase_tenants(client, rng)
        phase_cms(client, rng, card)
        kernel["launches"] = cms_seq.LAUNCHES
        check(kernel["launches"] > 0, "the main path never launched K1")
        phase_hll(client, rng, card)
        phase_bitset(client, rng, card)
        cms_seq.LAUNCHES = 0  # phase 8's path, counted on its own
        phase_lifecycle(client, rng, g, args.seed, card)
        check(cms_seq.LAUNCHES > 0, "phase 8 never launched K1")
        kernel["launches"] += cms_seq.LAUNCHES
    finally:
        client.shutdown()
    phase_interleaved(rng)
    log({"kernels": [kernel]})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
