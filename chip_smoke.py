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
  phase 9  failure and overload on a fresh client (breakers open on the
           second failure): per kind (config 1 Bloom loaded with 2**20 keys,
           a config 2 HLL, a config 3 2**30-bit BitSet), a chaos rule on the
           kind's dispatch methods opens its breaker, a degraded window is
           served by the host mirror and held to the golden model op for op,
           and after clearing, the breaker closes and the reconciled row
           equals the golden state on the card; config 5 streams 2**20
           events on K1, 2**18 on the mirror (whole-call estimates), 2**20
           on K1 again (K1 launches; the table is the uint32 sum of every
           event); a seeded 5% schedule over dispatch, fetch and staged H2D
           under 4 threads loses no acknowledged write; 1000 calls under a
           50 ms deadline shed under injected pressure without a launch; a
           burster tenant is throttled while a 3-thread victim completes
           every op; a sleep kernel ahead of one launch outlasts
           fetch_timeout_ms (DispatchTimeoutError, a breaker failure, and
           the op still lands).  Phases 2-8 end with no op served degraded
           and every breaker closed
  phase 10 the host tiers on fresh clients: (10a) 102,400 Bloom tenants
           of 10,000 keys / 1% over a 1024-row device budget (all but
           1016 born on the host; a 256 MiB host cap spills the cold tail
           to blobs under build/), a 40,960-op zipf(1.1) stream of
           128-key ops, every per-op result equal to an all-resident
           client's and 256 sampled tenants byte-equal across the tiers;
           four CMS(5, 65536), two HLLs and two 2**24-bit BitSets forced
           through demote, spill, load and promote with their bytes
           unchanged, then K1 on each promoted CMS row equal to
           golden_seq; the hot pass of the 256 hottest tenants tiered
           against all-resident (hot_ratio); transition p50/p99.
           (10b) config 1's filter with 100,000 keys, 4096 + 4096 zipf(1.3)
           single-key contains with the near cache on and off: equal
           answers, a cached negative retired by an add.  (10c) the first
           batch per bucket with and without pre-warm, each arm in a
           child process (``--p10c-child``); no first launch after
           prewarm_wait.  (10d) phase 3's run with the near cache on and
           off, in turns.  Then the BitSet answers past 2**31 bits
  phase 11 the RESP front door on fresh card clients, with the native
           codec required (RTPU_REQUIRE_NATIVE_RESP=1): (11a) config 1 over
           the wire — BF.RESERVE cfg1 0.01 1000000, 2**20 keys as BF.MADD
           commands of 1024 keys from 4 pipelining connections, every flag
           within the golden model's bounds, the row equal to the golden
           bitmap, 131,072 outside keys through BF.MEXISTS equal to golden
           and the FPP within 3 sigma; wire ops/s.  (11b) config 6's
           pipelined stream (4 connections, 256-deep batches, zipf(1.3)
           spans of Bloom, strings and bitmap) on a vectorizing and a
           sequential server: every connection's replies and the rows
           byte-identical; cmds/s, fusion ratio, response-cache hit rate,
           and the device idle share over one pass.  (11c) config 8: 1000
           idle connections and 32 closed-loop single-command clients in
           child processes, reactor against thread-per-connection: a fixed
           serving-thread count, replies equal to a sequential replay;
           cmds/s, p50/p99.  (11d) ``python -m redisson_tpu_torch --device
           cuda`` with a snapshot directory: a session over every family,
           SIGTERM (drain, snapshot, exit 0), a reboot that answers every
           read as before; INFO server names the card
  phase 12 the data grid on fresh card clients: (12a) config 5 through
           its real pipe at bench_config5_stream_topk's shape — CMS(5,
           65536) with top-20 tracking, 16,000,000 zipf(1.2) % 100,000
           uint64 events published as 32,768-event array messages (one
           warm message first) through RTopic -> TopicCmsBridge ->
           add_all_async -> cms_add -> coalescer -> cms_update_estimate;
           the table equals the golden count-min over every event,
           total_count() and events_ingested equal the event count, top-10
           recall 1.0, no op served degraded; events/s, dispatches and
           events per dispatch, the device idle share of the timed window.
           (12b) the grid families over the wire on a card server (reactor
           on): a session of lists, hashes, sets, sorted sets with the SCAN
           family and the STORE commands, streams with a consumer group,
           geo and WRONGTYPE, byte-equal to a CPU server's replies and to
           Redis's literal replies where known; pub/sub across two
           connections; a BLPOP parked while another connection pipelines
           1000 BF.MEXISTS/GET commands, all answered, the serving-thread
           count unchanged, then woken by an LPUSH.  (12c) ``python -m
           redisson_tpu_torch`` with a snapshot directory: lists, hashes,
           sorted sets, a stream with a consumer group and a geo set over
           the wire, SIGTERM, a reboot that answers every read equal.  K1
           launches in phase 12 are counted and must be 0: the bridge takes
           the vectorized cms_add, not K1
  phase 13 the coordination and services half on fresh card clients:
           (13a) config 1 through ``client.reactive()``: try_init(1,048,576,
           0.01), asyncio.gather of 4 add_all_async awaits of 262,144 keys,
           then of 4 contains_each awaits of 2**20 keys; the row, every
           contains flag and the FPP equal a sync client's run of the same
           keys and the golden model, the sync run's add flags equal the
           sequential golden model and each concurrent await's lie within
           phase 11a's bounds; keys/s beside phase 2's.  (13b) an executor
           service with 4 workers runs 4 tasks, each add_all_seq of 524,288
           zipf(1.2) events into its own CMS(5, 65536): K1 launches, every
           estimate and table equal to golden_seq.  (13c) 8 threads x 500
           rounds of lock, BitSet cardinality() on the card, set that bit,
           unlock: the set bits are exactly 0..3999; a 2-permit semaphore
           around 8 threads' HLL add_all never sees a third holder and the
           registers equal the golden model; a transaction over a map and
           a bucket commits and a conflicting one raises
           TransactionException; lock-hold p50/p99.  (13d) a LocalCachedMap
           of 100,000 entries read twice: the second pass's hit rate and get
           p50/p99, and two handles agree after a put through either.
           (13e) get_nodes() is the card, ping_all(), 100 pings' p50/p99, a
           1 s failure monitor without a down event.  (13f) a profiler trace
           of a 262,144-key Bloom pass holds CUDA kernel events,
           device_memory() reports the card's total memory, ops_total grows
           by exactly the pass's ops, and the scrape endpoint on loopback
           serves every family of the registry.  K1 launches in phase 13
           are counted (13b) and must be more than 0
  phase 14 the op journal, crash recovery and replication on fresh card
           clients (directories under build/, df -T printed once): (14a)
           config 1's 2**20 keys as 1024 add_all calls of 1024 keys from 4
           threads in four arms on one client — journal off, appendfsync
           no, everysec, always, each on a fresh filter whose row must
           equal the golden bitmap; keys/s, records, journal bytes per key,
           fsyncs, records per fsync (group commit) and the fsync p50/p99;
           then config 5 (CMS(5, 65536)) add_all_seq of 2**20 zipf(1.2)
           events under always (K1; estimates equal golden_seq, table
           equal golden).  (14b) a child (``--p14-child``) runs the always
           Bloom arm, a snapshot, the CMS stream, an HLL PFADD of 2**21
           keys and a 2**30-bit BitSet's set_many of 2**21 indexes, one ACK
           per resolved call; SIGKILL after the last ack; a fresh card
           client restores, replays and writes back: every row equal to
           the golden state of the acked ops, the live K1 table equal to
           the rebuilt one, and 2**18 more events through K1 on the
           recovered row equal to golden_seq; recovery seconds, records
           and rows.  (14c) ``python -m redisson_tpu_torch.chaos.crashchild
           --device cuda`` for 3 seeds x {always, everysec}, plus runs with
           --snapshot-every 50 and --residency-every 25, killed at seeded
           ack counts, recovered on the card and matched to a golden
           prefix (always: covering every ack; everysec: every ack older
           than 2.5 s).  (14d) a primary and a replica RespServer on two
           card clients: FULLRESYNC of config 1 + config 5, then 2**20 keys
           of BF.MADD from 4 connections with WAIT 1 1000 every 64
           commands; replica rows byte-equal, -READONLY, a dropped link
           resyncing partially, FAILOVER, every WAIT-covered write read
           back from the promoted node.  (14e) ``python -m
           redisson_tpu_torch --journal-dir --snapshot-dir`` with CONFIG
           SET appendfsync always, SIGKILLed mid-pipeline and rebooted:
           every acknowledged SET and BF.MADD key reads back.  K1 launches
           in phase 14 (14a, 14b's recovered row, 14d) must be more than 0

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
import socket
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
    RATES.update(add_ops_per_s=n_load / add_s,
                 contains_ops_per_s=sum(map(len, batches)) / contains_s)
    log({"phase": 2, "config": "bloom 1M keys 1% FPP", "added": n_added,
         "add_ops_per_s": n_load / add_s,
         "contains_ops_per_s": sum(map(len, batches)) / contains_s,
         "fpp": fpp, "fpp_expected": p_theory, "fpp_3sigma": 3 * sigma,
         "row_equals_golden": True, "card": card})
    return g


# -- phase 3: multi-tenant coalesced runs -------------------------------------


def phase_tenants(client, rng, phase=3) -> float:
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
    ops_per_s = n_tenants * 5 * per_op / wall_s
    log({"phase": phase, "tenants": n_tenants, "threads": n_threads,
         "ops": n_tenants * 5 * per_op, "ops_per_s": ops_per_s,
         "flushes": len(runs_per_flush), "max_runs_per_flush": max(runs_per_flush),
         "results_equal_golden": True})
    return ops_per_s


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

    # The name is gone once the reaper detaches it; the row is zeroed and
    # then freed after that, under the dispatch lock: wait for the free.
    while row not in pool._free:
        check(time.perf_counter() - t0 < 5.0, "the expired HLL's row was not freed in 5 s")
        time.sleep(0.01)
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
        check_healthy(client, 7)
        check(max(runs["per_op"], default=0) > 1024, f"no flush of more than 1024 runs: {runs}")
        check(max(runs["runs"], default=0) > 1, f"no multi-run flush: {runs}")
        log({"phase": 7, "threads": n_threads, "bitsets": len(names), "ops": n_ops,
             "ops_per_s": n_ops / wall_s, "runs_flushes": runs["runs"],
             "per_op_flush_ops": runs["per_op"], "results_equal_golden": True})
    finally:
        client.shutdown()


# -- phase 9: failure and overload on the card ----------------------------------

# Knobs of phase 9's clients: a breaker opens on the second consecutive
# failure, retries and backoffs take milliseconds.  The open window must
# outlast seeding the 2**30-bit mirror (a 128 MiB D2H and a decode to 1 GiB
# of bools, half a second or more): the recovery probe is a row read, so
# under a fault that hits only the kind's methods it succeeds, and a
# breaker that closes in the middle of a seed discards it.
P9_KNOBS = {"breaker_failure_threshold": 2, "breaker_open_ms": 2000,
            "retry_max_backoff_ms": 20}
P9_RETRY = {"retry_attempts": 2, "retry_interval_ms": 2}
# The dispatch methods of each kind's coalesced path (chaos points
# dispatch.<method>), and K1's for the CMS.
KIND_POINTS = {
    "bloom": ("dispatch.bloom_mixed_keys_runs", "dispatch.bloom_mixed_keys"),
    "hll": ("dispatch.hll_add_changed",),
    "bitset": ("dispatch.bitset_mixed_runs", "dispatch.bitset_mixed"),
    "cms": ("dispatch.cms_update_estimate", "dispatch.cms_update_estimate_seq"),
}


def p9_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(**P9_KNOBS, **kw)
    cfg.retry_attempts = P9_RETRY["retry_attempts"]
    cfg.retry_interval_ms = P9_RETRY["retry_interval_ms"]
    return rt.create(cfg)


def typed_errors():
    from redisson_tpu_torch import chaos
    from redisson_tpu_torch.executor.failures import RedissonTpuError

    return (RedissonTpuError, chaos.FaultInjected, chaos.CorruptionDetected)


def until(cond, what: str, timeout: float = 30.0) -> float:
    """Poll ``cond`` with a deadline; the seconds it took."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"{what} within {timeout} s")
        time.sleep(0.002)
    return time.perf_counter() - t0


def check_healthy(client, phase) -> None:
    """Phases 2-8 run on a healthy card: no op served degraded, every
    breaker closed, no mirror."""
    from redisson_tpu_torch.obs import total

    eng = client._engine
    check(total(eng.obs.degraded_ops) == 0, f"phase {phase}: ops were served degraded")
    check(eng.health.board.open_count() == 0 and not eng._mirrors
          and not eng.health.any_degraded, f"phase {phase}: a breaker is not closed")


def trip(client, kind: str, name: str, op):
    """Fail the kind's dispatch methods until its breaker opens and ``op``
    is answered by the host mirror (seeded from the device row: its D2H
    and decode are inside the failover time).  Then hold the breaker open
    through the degraded window: the recovery probe's row read fails too.
    Returns (the first mirror answer, failover seconds)."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    served = eng.obs.degraded_ops
    for p in KIND_POINTS[kind]:
        chaos.inject(p, "error", 1.0)
    t0 = time.perf_counter()
    while True:
        before = served.get((kind,))
        try:
            res = op()
        except typed_errors():
            check(time.perf_counter() - t0 < 60, f"{kind} never failed over")
            continue
        check(served.get((kind,)) > before, f"{kind}: an op reached the failing device")
        break
    failover_s = time.perf_counter() - t0
    check(eng.health.degraded_kind(kind) and eng.health.state() != "healthy",
          f"{kind}: health does not show the degraded kind")
    chaos.inject("dispatch.read_row", "error", 1.0)
    return res, failover_s


def heal(client, kind: str) -> float:
    """Clear the schedule and poll until the breaker closed and the mirrors
    reconciled; the reconcile's own seconds (encode + H2D)."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    eng.reconcile_seconds.pop(kind, None)
    chaos.clear()
    # The reconcile records its time after it releases the mirror lock.
    until(lambda: not eng._mirrors and not eng.health.any_degraded
          and eng.health.board.open_count() == 0 and kind in eng.reconcile_seconds,
          f"{kind} reconcile")
    return eng.reconcile_seconds[kind]


def words_on_card(bits: np.ndarray, row_units: int, dev) -> torch.Tensor:
    """A bool bitmap as the int32 bit-view row the card holds."""
    padded = np.zeros(row_units * 32, bool)
    padded[: bits.size] = bits
    words = np.packbits(padded, bitorder="little").view(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(dev)


def p9_bloom(client, rng, dev) -> dict:
    from redisson_tpu_torch.utils import hashing

    bf = client.get_bloom_filter("p9-cfg1")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    load = np.arange(1 << 20, dtype=np.uint64)
    for i in range(4):
        bf.add_all_async(load[i << 18 : (i + 1) << 18]).result()
    g = golden_bloom(bf, load)

    def reduce(keys):
        return hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), g.size)

    first, failover_s = trip(client, "bloom", "p9-cfg1", lambda: bf.add(1 << 40))
    check(first == bool(g.add_hashed(*reduce(np.array([1 << 40], np.uint64)))[0]),
          "bloom: the first mirror answer differs from golden")
    adds = rng.integers(0, 1 << 21, 1 << 17).astype(np.uint64)
    probes = rng.integers(0, 1 << 22, 1 << 17).astype(np.uint64)
    t0 = time.perf_counter()
    got_add = bf.add_all_async(adds).result()
    got_has = bf.contains_each(probes)
    window_s = time.perf_counter() - t0
    check(np.array_equal(got_add, g.add_hashed(*reduce(adds))), "bloom: degraded adds differ")
    check(np.array_equal(got_has, g.contains_hashed(*reduce(probes))),
          "bloom: degraded contains differ")
    reconcile_s = heal(client, "bloom")
    e = client._engine.registry.lookup("p9-cfg1")
    check(torch.equal(row_view(client, "p9-cfg1"), words_on_card(g.bits, e.pool.row_units, dev)),
          "bloom: the reconciled row differs from golden")
    return {"failover_s": failover_s, "degraded_ops": 2 << 17,
            "degraded_ops_per_s": (2 << 17) / window_s, "reconcile_s": reconcile_s}


def p9_hll(client) -> dict:
    from redisson_tpu_torch.ops import golden

    h = client.get_hyper_log_log("p9-cfg2")
    base = np.arange(1 << 21, dtype=np.uint64)
    h.add_all_async(base).result()
    g = golden.GoldenHyperLogLog()
    g.add_hashed(*hll_lanes(base))

    def golden_add(keys) -> bool:
        before = g.regs.copy()
        g.add_hashed(*hll_lanes(keys))
        return bool(np.any(g.regs != before))

    first, failover_s = trip(client, "hll", "p9-cfg2", lambda: h.add(1 << 40))
    check(first == golden_add(np.array([1 << 40], np.uint64)), "hll: first mirror answer")
    calls = np.arange(1 << 21, (1 << 21) + (1 << 19), dtype=np.uint64).reshape(64, -1)
    t0 = time.perf_counter()
    got = [h.add_all(keys) for keys in calls]
    count = h.count()
    window_s = time.perf_counter() - t0
    check(got == [golden_add(keys) for keys in calls], "hll: degraded PFADD results differ")
    check(count == g.count(), f"hll: degraded count {count} vs golden {g.count()}")
    reconcile_s = heal(client, "hll")
    check(torch.equal(row_view(client, "p9-cfg2"), torch.from_numpy(g.regs).to(row_view(
        client, "p9-cfg2").device)), "hll: the reconciled registers differ from golden")
    check(h.count() == count, "hll: count after reconcile")
    return {"failover_s": failover_s, "degraded_ops": 1 << 19,
            "degraded_ops_per_s": (1 << 19) / window_s, "reconcile_s": reconcile_s}


def golden_ops(bits: np.ndarray, idx: np.ndarray, op: str) -> np.ndarray:
    """Previous bit per op, one op at a time, on a bool bitmap."""
    prev = np.empty(len(idx), bool)
    for j, i in enumerate(idx.tolist()):
        prev[j] = bits[i]
        if op == "set":
            bits[i] = True
        elif op == "clear":
            bits[i] = False
        elif op == "flip":
            bits[i] = not prev[j]
    return prev


def p9_bitset(client, rng, dev) -> dict:
    nbits = 1 << 30
    eng = client._engine
    bs = client.get_bit_set("p9-cfg3")
    bits = np.zeros(nbits, bool)
    warm = rng.integers(0, nbits, 1 << 21).astype(np.uint32)
    warm[0] = nbits - 1
    bs.set_many(warm)
    bits[warm] = True
    first, failover_s = trip(client, "bitset", "p9-cfg3", lambda: bs.set(12345))
    check(first == golden_ops(bits, np.array([12345]), "set")[0], "bitset: first mirror answer")
    mirror_bytes = eng._mirrors["p9-cfg3"].bits.nbytes
    parts = [(op, rng.integers(0, nbits, 1 << 16).astype(np.uint32))
             for op in ("set", "clear", "flip", "get")]
    parts[2][1][:4096] = parts[0][1][:4096]  # flips that meet this window's sets
    t0 = time.perf_counter()
    got = []
    for op, idx in parts:
        if op == "set":
            got.append(bs.set_many(idx))
        elif op == "clear":
            got.append(eng.bitset_set("p9-cfg3", idx, False).result())
        elif op == "flip":
            got.append(eng.bitset_flip("p9-cfg3", idx).result())
        else:
            got.append(bs.get_many(idx))
    window_s = time.perf_counter() - t0
    for (op, idx), res in zip(parts, got):
        check(np.array_equal(res, golden_ops(bits, idx, op)), f"bitset: degraded {op} differs")
    check(bs.cardinality() == int(bits.sum()), "bitset: degraded cardinality")
    reconcile_s = heal(client, "bitset")
    e = eng.registry.lookup("p9-cfg3")
    check(torch.equal(row_view(client, "p9-cfg3"), words_on_card(bits, e.pool.row_units, dev)),
          "bitset: the reconciled row differs from golden")
    return {"failover_s": failover_s, "degraded_ops": 1 << 18,
            "degraded_ops_per_s": (1 << 18) / window_s, "reconcile_s": reconcile_s,
            "mirror_host_bytes": int(mirror_bytes)}


def p9_cms(client, rng) -> dict:
    """K1 through a trip: 2**20 events on K1, 2**18 on the host mirror,
    2**20 on K1 again."""
    from redisson_tpu_torch.ops import cms_seq, golden
    from redisson_tpu_torch.utils import hashing

    d, w = 5, 1 << 16
    cms = client.get_count_min_sketch("p9-cms")
    check(cms.try_init(d, w), "try_init refused")

    def reduce(keys):
        return hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(keys)), w)

    table = np.zeros((d, w), np.uint32)
    cells = []  # every event's d cells, for the plain uint32 sum

    def k1_window(events):
        nonlocal table
        h1w, h2w = reduce(events)
        before = cms_seq.LAUNCHES
        est = cms.add_all_seq(events)
        launched = cms_seq.LAUNCHES - before
        check(launched == -(-len(events) // client._engine._SEQ_CHUNK),
              f"cms: {launched} K1 launches")
        table, want = cms_seq.golden_seq(table, h1w, h2w, np.ones(len(events), np.uint32),
                                         d=d, w=w)
        check(np.array_equal(est, want), "cms: K1 estimates differ from golden_seq")
        cells.append((h1w, h2w))
        return launched

    def mirror_call(events, fn):
        nonlocal table
        h1w, h2w = reduce(events)
        g = golden.GoldenCountMinSketch(d, w)
        g.counts = table.copy()
        g.add_hashed(h1w, h2w)
        want = g.estimate_hashed(h1w, h2w)
        got = fn()
        table = g.counts
        cells.append((h1w, h2w))
        check(np.array_equal(np.asarray(got), want),
              "cms: degraded estimates differ from the whole-call golden model")

    k1_window(zipf_keys(rng, 1 << 20))
    key = np.array([1 << 40], np.uint64)
    first, failover_s = trip(client, "cms", "p9-cms", lambda: cms.add_all(key))
    mirror_call(key, lambda: first)
    events = zipf_keys(rng, 1 << 18)
    t0 = time.perf_counter()
    mirror_call(events, lambda: cms.add_all_seq(events))
    window_s = time.perf_counter() - t0
    reconcile_s = heal(client, "cms")
    k1_after = k1_window(zipf_keys(rng, 1 << 20))
    plain = np.zeros(d * w, np.uint64)
    for h1w, h2w in cells:
        idx = h1w.astype(np.uint64)
        for r in range(d):
            np.add.at(plain, r * w + idx, 1)
            idx = (idx + h2w) % w
    check(np.array_equal(tenant_row(client, "p9-cms")[: d * w],
                         (plain % (1 << 32)).astype(np.uint32)),
          "cms: the table differs from the uint32 sum of every event")
    return {"failover_s": failover_s, "degraded_ops": 1 << 18,
            "degraded_ops_per_s": (1 << 18) / window_s, "reconcile_s": reconcile_s,
            "k1_launches_after_reconcile": k1_after}


def p9_soak(client, seed: int) -> dict:
    """4 threads of mixed multi-tenant ops under a seeded 5% schedule over
    every dispatch, fetch and staged H2D: every call resolves (a value or a
    typed error), and after clearing no breaker is open, no mirror is left,
    and every acknowledged write reads back."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    n_threads, n_calls = 4, 400
    for t in range(n_threads):
        check(client.get_bloom_filter(f"soak-bf{t}").try_init(100_000, 0.01), "try_init")
        eng.bitset_ensure(f"soak-bs{t}", 1 << 16)
        check(client.get_count_min_sketch(f"soak-cms{t}").try_init(4, 4096), "try_init")
    acked = [{"bloom": [], "bits": [], "cms": 0, "hll": 0} for _ in range(n_threads)]
    failed, untyped = [0] * n_threads, []
    typed = typed_errors()

    def worker(t):
        rng = np.random.default_rng(seed * 100 + t)
        bf = client.get_bloom_filter(f"soak-bf{t}")
        bs = client.get_bit_set(f"soak-bs{t}")
        cms = client.get_count_min_sketch(f"soak-cms{t}")
        hll = client.get_hyper_log_log(f"soak-h{t}")
        for i in range(n_calls):
            keys = rng.integers(0, 1 << 20, 32).astype(np.uint64)
            try:
                if i % 5 == 0:
                    bf.add_all_async(keys).result()
                    acked[t]["bloom"].append(keys)
                elif i % 5 == 1:
                    idx = (keys % (1 << 16)).astype(np.uint32)
                    bs.set_many_async(idx).result()
                    acked[t]["bits"].append(idx)
                elif i % 5 == 2:
                    cms.add_all(keys)
                    acked[t]["cms"] += len(keys)
                elif i % 5 == 3:
                    hll.add_all(keys)
                    acked[t]["hll"] += 1
                else:
                    bf.contains_each(keys)
                    bs.get_many((keys % (1 << 16)).astype(np.uint32))
            except typed:
                failed[t] += 1
            except Exception as e:  # noqa: BLE001 - the check below reports it
                untyped.append(repr(e))

    chaos.install(chaos.ChaosSchedule(seed=seed, rate=0.05,
                                      points=("dispatch", "fetch", "h2d.staging")))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    soak_s = time.perf_counter() - t0
    injected = sum(chaos.counts().values())
    chaos.clear()
    check(not any(th.is_alive() for th in threads), "soak workers hung")
    check(not untyped, f"untyped failures in the soak: {untyped[:3]}")
    recover_s = until(lambda: eng.health.board.open_count() == 0 and not eng._mirrors
                      and not eng.health.any_degraded, "soak recovery", 60)
    for t in range(n_threads):
        bf = client.get_bloom_filter(f"soak-bf{t}")
        for keys in acked[t]["bloom"]:
            check(bf.contains_all(keys) == len(keys), "soak: an acked bloom add was lost")
        bs = client.get_bit_set(f"soak-bs{t}")
        for idx in acked[t]["bits"]:
            check(bs.get_many(idx).all(), "soak: an acked bitset set was lost")
        total = client.get_count_min_sketch(f"soak-cms{t}").total_count()
        check(total >= acked[t]["cms"], f"soak: CMS total {total} < acked {acked[t]['cms']}")
    return {"calls": n_threads * n_calls, "failed_calls": sum(failed),
            "faults_injected": injected, "soak_s": soak_s,
            "degrade_events": eng.health.degrade_events,
            "recoveries": eng.health.recoveries, "recover_s": recover_s}


def p9_stall(dev) -> dict:
    """A real stall: a sleep kernel ahead of one launch on the executor's
    stream outlasts fetch_timeout_ms, so the waiter gets
    DispatchTimeoutError, the fetch timeout and a breaker failure are
    recorded, and the op still lands (applied but reported failed)."""
    from redisson_tpu_torch.executor.failures import DispatchTimeoutError
    from redisson_tpu_torch.obs import total

    client = p9_client(fetch_timeout_ms=50)
    try:
        eng = client._engine
        bf = client.get_bloom_filter("stall")
        check(bf.try_init(100_000, 0.01), "try_init refused")
        warm = np.arange(4096, dtype=np.uint64)
        bf.add_all_async(warm).result()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 20)
        end.record()
        torch.cuda.synchronize()
        cycles = int((1 << 20) * 1000.0 / start.elapsed_time(end))  # ~1 s
        keys = np.arange(1 << 20, (1 << 20) + 4096, dtype=np.uint64)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fut = bf.add_all_async(keys)
        try:
            fut.result()
            fail("the stalled launch came home within fetch_timeout_ms")
        except DispatchTimeoutError:
            waited_s = time.perf_counter() - t0
        failures = max(b.failures for b in eng.health.board._breakers.values())
        timeouts = total(eng.obs.fetch_timeouts)
        check(timeouts == 1 and failures >= 1,
              f"fetch timeouts {timeouts}, breaker failures {failures}")
        torch.cuda.synchronize()
        until(fut.done, "the stalled launch")
        check(bf.contains_all(keys) == len(keys), "the stalled op did not land")
        return {"fetch_timeout_ms": 50, "stall_cycles": cycles, "waited_s": waited_s,
                "fetch_timeouts": timeouts, "breaker_failures": failures}
    finally:
        client.shutdown()


def count_dispatches(ex):
    """Counting spies on every executor method that launches work;
    ``counts["restore"]()`` removes them."""
    names = (*_DISPATCHES, "cms_update_estimate_seq", "bloom_contains_keys_st",
             "bloom_add_keys_st")
    counts = {"n": 0}
    for name in names:
        orig = getattr(ex, name)

        def spy(*a, _orig=orig, **k):
            counts["n"] += 1
            return _orig(*a, **k)

        setattr(ex, name, spy)

    def restore():
        for name in names:
            delattr(ex, name)

    counts["restore"] = restore
    return counts


def p9_overload(client) -> dict:
    from redisson_tpu_torch import chaos
    from redisson_tpu_torch.executor.failures import (
        DeadlineExceededError,
        TenantThrottledError,
    )

    eng = client._engine
    bf = client.get_bloom_filter("p9-over")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    bf.add_all_async(np.arange(1024, dtype=np.uint64)).result()
    launches = count_dispatches(eng.executor)
    chaos.inject("overload.pressure", "pressure", 1.0, latency_s=30.0)
    shed_us = []
    for i in range(1000):
        t0 = time.perf_counter()
        try:
            with client.op_deadline(50):
                if i % 2:
                    bf.add(i)
                else:
                    bf.contains(i)
            fail("a deadline call under pressure was not shed")
        except DeadlineExceededError as e:
            check(e.stage == "admission", f"shed at {e.stage}")
        shed_us.append((time.perf_counter() - t0) * 1e6)
    check(launches["n"] == 0, f"{launches['n']} launches for shed calls")
    for i in range(10):
        check(bf.add(1 << 30 | i) and bf.contains(1 << 30 | i), "a no-deadline call")
    check(launches["n"] > 0, "no-deadline calls did not launch")
    chaos.clear()
    launches["restore"]()

    victim = client.get_bloom_filter("p9-victim")
    check(victim.try_init(1_000_000, 0.01), "try_init refused")
    burster = client.get_bloom_filter("p9-burster")
    check(burster.try_init(1_000_000, 0.01), "try_init refused")
    eng.governor.set_limits(rate_limit=4_000_000, burst=1_000_000)

    def victim_run(duration_s, tag):
        acked, failures, ops = [], [], [0]
        stop = time.perf_counter() + duration_s

        def vt(t):
            rng = np.random.default_rng(t)
            while time.perf_counter() < stop:
                keys = rng.integers(0, 1 << 40, 128).astype(np.uint64)
                try:
                    victim.add_all_async(keys).result()
                    acked.append(keys)
                    check(victim.contains_all_async(keys).result().all(), "victim read")
                    ops[0] += 256
                except Exception as e:  # noqa: BLE001 - the check below reports it
                    failures.append(repr(e))

        threads = [threading.Thread(target=vt, args=(t,)) for t in range(3)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        check(not any(th.is_alive() for th in threads), "victim threads hung")
        check(not failures, f"victim ops failed ({tag}): {failures[:3]}")
        return ops[0] / (time.perf_counter() - t0), acked

    alone, acked = victim_run(1.5, "alone")
    stop = threading.Event()
    burst = {"ok": [], "throttled": 0}

    def burster_run():
        i = 0
        while not stop.is_set():
            keys = np.arange(i << 20, (i + 1) << 20, dtype=np.uint64)
            try:
                burster.add_all_async(keys).result()
                burst["ok"].append(keys)
            except TenantThrottledError:
                burst["throttled"] += 1
                time.sleep(0.001)
            i += 1

    bt = threading.Thread(target=burster_run)
    bt.start()
    try:
        contested, acked2 = victim_run(1.5, "burst")
    finally:
        stop.set()
        bt.join(timeout=60)
    eng.governor.set_limits(rate_limit=0, burst=0)
    check(burst["throttled"] > 0, "the burster was never throttled")
    for keys in acked + acked2:
        check(victim.contains_all(keys) == len(keys), "an acked victim write was lost")
    for keys in burst["ok"]:
        check(burster.contains_all(keys) == len(keys), "an acked burster write was lost")
    return {"shed_calls": 1000, "shed_p50_us": float(np.percentile(shed_us, 50)),
            "shed_p99_us": float(np.percentile(shed_us, 99)),
            "victim_ops_per_s_alone": alone, "victim_ops_per_s_with_burster": contested,
            "burster_throttled_calls": burst["throttled"],
            "burster_acked_calls": len(burst["ok"])}


def phase_failover(rng, seed: int, card: str) -> None:
    from redisson_tpu_torch.obs import total

    dev = torch.device("cuda")
    log({"phase": 9, "knobs": {**P9_KNOBS, **P9_RETRY}, "card": card})
    client = p9_client()
    try:
        kinds = {"bloom": p9_bloom(client, rng, dev), "hll": p9_hll(client),
                 "bitset": p9_bitset(client, rng, dev), "cms": p9_cms(client, rng)}
        served = {k: client._engine.obs.degraded_ops.get((k,)) for k in kinds}
        soak = p9_soak(client, seed)
        overload = p9_overload(client)
        degraded_total = total(client._engine.obs.degraded_ops)
    finally:
        client.shutdown()
    stall = p9_stall(dev)
    log({"phase": 9, "kinds": kinds, "degraded_ops_served": served,
         "degraded_ops_total": degraded_total, "soak": soak, "stall": stall,
         "overload": overload, "card": card})


# -- phase 10: the residency ladder, the near cache and pre-warm ----------------

# Phase 10a: bench.py config 11's shape at a population a multi-tenant
# deployment holds — 100x the device-row budget in Bloom tenants of
# 10,000 keys / 1% FPP, a zipf(1.1) tenant stream of 128-key ops with an
# add every third op, the cold tail past a 256 MiB host cap spilling to
# disk, and config 11's 30 s heat half-life.  The hot set is the stream's
# actual head; the tenant ids are a seeded permutation of the zipf ranks,
# so the hot set is mostly born cold and has to be promoted by heat.
# The stream is cut from 65,536 ops to 40,960 for the script's time
# limit (the tiered stream ran at 171-174 ops/s on the card); at this
# length the ~17,500 tenants it touches still overflow the host cap, so
# the cold tail spills.  The population and the budget are not cut.
P10 = {"pop": 102_400, "budget": 1024, "ops": 40_960, "keys": 128, "hot": 256,
       "hot_keys": 1 << 14, "hot_passes": 4, "host_bytes": 256 << 20,
       "cms": (4, 5, 1 << 16), "cms_events": 1 << 18, "seq_events": 1 << 15,
       "hlls": 2, "hll_keys": 1 << 20, "bitsets": 2, "bitset_bits": 1 << 24,
       "sample": 256, "nc_keys": 100_000, "nc_reads": 4096}
P10_DEVICE = "cuda"


def p10_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P10_DEVICE, **kw))


def p10_truth(client, name: str) -> np.ndarray:
    """The object's state in device-row layout, whatever its tier (a DISK
    tenant loads)."""
    eng = client._engine
    return np.asarray(eng._host_row(eng.registry.lookup(name))).copy()


def p10_stream(client, names, stream, keys):
    """The op stream, issued pipelined (config 11's loop): per-op results
    packed 8 per byte, the errors, and the seconds it took."""
    from collections import deque

    out = np.zeros((len(stream), keys.shape[1] // 8), np.uint8)
    errors = 0
    futs = deque()

    def collect(j, f):
        nonlocal errors
        try:
            out[j] = np.packbits(np.asarray(f.result(), bool))
        except Exception:
            errors += 1

    t0 = time.perf_counter()
    for j, t in enumerate(stream):
        bf = client.get_bloom_filter(names[t])
        futs.append((j, bf.add_all_async(keys[j]) if j % 3 == 0
                     else bf.contains_all_async(keys[j])))
        while futs and futs[0][1].done():
            collect(*futs.popleft())
    while futs:
        collect(*futs.popleft())
    return out, errors, time.perf_counter() - t0


def p10_hot_pass(client, names, hot, rng) -> float:
    """Config 11's hot pass: contains over the hot set, 2**14 keys per op,
    all issued before any is collected; key-ops/s."""
    keys = [rng.integers(0, 1 << 40, P10["hot_keys"], dtype=np.uint64)
            for _ in range(P10["hot_passes"])]
    filters = [client.get_bloom_filter(names[t]) for t in hot]
    for f in filters:  # warm-up outside the clock
        f.contains_all_async(keys[0]).result()
    if P10_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kp in keys:
        futs = [f.contains_all_async(kp) for f in filters]
        for fu in futs:
            fu.result()
    return P10["hot_passes"] * len(filters) * P10["hot_keys"] / (time.perf_counter() - t0)


def p10_other_kinds(client, rng) -> list:
    """The four CMSes, two HLLs and two BitSets the ladder moves whole;
    created before the Bloom population, so they hold device rows."""
    n_cms, d, w = P10["cms"]
    names = []
    for i in range(n_cms):
        cms = client.get_count_min_sketch(f"p10-cms{i}")
        check(cms.try_init(d, w), "try_init refused")
        cms.add_all(zipf_keys(rng, P10["cms_events"]))  # the multi-tenant path
        names.append(f"p10-cms{i}")
    for i in range(P10["hlls"]):
        client.get_hyper_log_log(f"p10-hll{i}").add_all(
            rng.integers(0, 1 << 40, P10["hll_keys"], dtype=np.uint64))
        names.append(f"p10-hll{i}")
    for i in range(P10["bitsets"]):
        bs = client.get_bit_set(f"p10-bs{i}")
        bs.set(P10["bitset_bits"] - 1)
        bs.set_many(rng.integers(0, P10["bitset_bits"], 1 << 20), True)
        names.append(f"p10-bs{i}")
    return names


def p10_force_ladder(client, names, rng) -> dict:
    """Each object through demote -> spill -> load -> promote, its bytes
    equal to the pre-demotion bytes at every tier; then K1 on each promoted
    CMS row, its estimates equal to golden_seq on the host."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    rm = client._engine.residency
    for n in names:
        if client._engine.registry.lookup(n).row < 0:
            # The ladder may have demoted it (or spilled it) while the
            # stream ran: back to the card first.
            rm.load(n)
            check(rm.promote(n), f"promotion of {n} refused")
        before = p10_truth(client, n)
        for step in (rm.demote, rm.spill, rm.load, rm.promote):
            check(step(n), f"{step.__name__} of {n} refused")
            check(np.array_equal(p10_truth(client, n), before),
                  f"{n} changed on {step.__name__}")
        e = client._engine.registry.lookup(n)
        check(e.row >= 0 and e.residency == "device", f"{n} not back on the card")
    _, d, w = P10["cms"]
    launches = 0
    for n in names:
        if not n.startswith("p10-cms"):
            continue
        table = p10_truth(client, n)[: d * w].reshape(d, w)
        events = zipf_keys(rng, P10["seq_events"])
        before = cms_seq.LAUNCHES
        est = client.get_count_min_sketch(n).add_all_seq(events)
        launched = cms_seq.LAUNCHES - before
        check(launched >= 1, f"K1 never launched on the promoted row of {n}")
        launches += launched
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
        want_table, want = cms_seq.golden_seq(
            table, h1w, h2w, np.ones(len(events), np.uint32), d=d, w=w)
        check(np.array_equal(np.asarray(est, np.uint32), want),
              f"K1 on the promoted row of {n} differs from golden_seq")
        check(np.array_equal(p10_truth(client, n)[: d * w].reshape(d, w), want_table),
              f"{n} table after K1 differs from golden_seq")
    return {"objects": len(names), "k1_launches_on_promoted_rows": launches,
            "bytes_equal_on_every_tier": True, "k1_equals_golden_seq": True}


def p10_sample(rm_client, names, hot, rng) -> np.ndarray:
    """256 tenants: the hot set's head and tenants on each tier at the end."""
    eng = rm_client._engine
    by_tier = {"device": [], "host": [], "disk": []}
    for i, n in enumerate(names):
        e = eng.registry.lookup(n)
        tier = "device" if e.row >= 0 else ("host" if n in eng._mirrors else
                                             "disk" if e.residency == "disk" else None)
        if tier is not None and len(by_tier[tier]) < 64:
            by_tier[tier].append(i)
    picked = list(hot[:64])
    for ids in by_tier.values():
        picked += ids
    rest = rng.choice(len(names), P10["sample"], replace=False)
    picked = list(dict.fromkeys(int(i) for i in picked + list(rest)))[: P10["sample"]]
    return np.asarray(picked), {k: len(v) for k, v in by_tier.items()}


def phase_tiered(rng, card: str) -> None:
    from redisson_tpu_torch.obs import total

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    blob_dir = tempfile.mkdtemp(prefix="phase10-blobs-", dir=build)
    pop, budget = P10["pop"], P10["budget"]
    names = [f"p10-{i}" for i in range(pop)]
    perm = rng.permutation(pop)
    stream = perm[rng.zipf(1.1, P10["ops"]) % pop]
    keys = rng.integers(0, 1 << 40, (P10["ops"], P10["keys"]), dtype=np.uint64)
    counts = np.bincount(stream, minlength=pop)
    hot = np.argsort(-counts, kind="stable")[: P10["hot"]]
    tiered = p10_client(residency_device_rows=budget,
                        residency_max_host_bytes=P10["host_bytes"],
                        residency_dir=blob_dir, residency_heat_half_life_s=30.0)
    resident = None
    try:
        eng, rm = tiered._engine, tiered._engine.residency
        others = p10_other_kinds(tiered, rng)
        t0 = time.perf_counter()
        for n in names:
            tiered.get_bloom_filter(n).try_init(10_000, 0.01)
        create_s = time.perf_counter() - t0
        born_cold = sum(1 for n in names if eng.registry.lookup(n).row < 0)
        check(rm.device_rows_used() <= budget, "creation grew past the device budget")
        check(born_cold == pop - (budget - len(others)), f"{born_cold} born cold")
        res_t, err_t, mixed_t = p10_stream(tiered, names, stream, keys)
        st_stream = rm.stats()
        # The thread stops here: the forced ladder and the convergence
        # below drive maintain() by hand, as config 11 does.
        rm.shutdown()
        check(rm.errors == 0, f"{rm.errors} maintenance cycles failed")
        ladder = p10_force_ladder(tiered, others, rng)
        for t in hot:  # heat for the hot set (config 11 warms it too)
            for _ in range(4):
                tiered.get_bloom_filter(names[t]).contains_all_async(keys[0, :8]).result()
        for _ in range(8):
            rm.maintain()
        hot_resident = sum(1 for t in hot if eng.registry.lookup(names[t]).row >= 0)
        hot_tiered = p10_hot_pass(tiered, names, hot, rng)
        rm.maintain()
        rm.maintain()  # the second reclaims what the first quarantined
        used = rm.device_rows_used()
        check(used <= budget, f"{used} device rows in use past the budget {budget}")
        check(rm.errors == 0, "maintenance failed")

        resident = p10_client()
        for n in names:
            resident.get_bloom_filter(n).try_init(10_000, 0.01)
        res_r, err_r, mixed_r = p10_stream(resident, names, stream, keys)
        check(err_t == 0 and err_r == 0, f"stream errors: tiered {err_t}, resident {err_r}")
        check(np.array_equal(res_t, res_r),
              f"{int(np.sum(np.any(res_t != res_r, axis=1)))} ops differ tiered vs all-resident")
        hot_res = p10_hot_pass(resident, names, hot, rng)
        sample, sample_tiers = p10_sample(tiered, names, hot, rng)
        check(all(sample_tiers.values()), f"a tier is empty at the end: {sample_tiers}")
        for i in sample:
            e = resident._engine.registry.lookup(names[i])
            check(np.array_equal(p10_truth(tiered, names[i]),
                                 resident._engine.executor.read_row(e.pool, e.row)),
                  f"{names[i]} differs tiered vs all-resident")
        check(total(eng.obs.degraded_ops) == 0, "phase 10a: ops were served degraded")
        st = rm.stats()
        resident_rows = sum(p.used_rows() for p in resident._engine.registry.pools())
        log({"phase": "10a", "population": pop, "device_rows_budget": budget,
             "born_cold": born_cold, "create_s": create_s,
             "ops": P10["ops"], "keys_per_op": P10["keys"],
             "tiered_mixed_ops_per_s": P10["ops"] / mixed_t,
             "tiered_mixed_keys_per_s": P10["ops"] * P10["keys"] / mixed_t,
             "resident_mixed_ops_per_s": P10["ops"] / mixed_r,
             "resident_mixed_keys_per_s": P10["ops"] * P10["keys"] / mixed_r,
             "hot_set": len(hot), "hot_device_resident": hot_resident,
             "tiered_hot_keys_per_s": hot_tiered, "resident_hot_keys_per_s": hot_res,
             "hot_ratio": hot_res / hot_tiered, "hot_ratio_bar": 1.25,
             "errors": err_t + err_r + rm.errors, "per_op_results_equal": True,
             "sample": len(sample), "sample_tiers": sample_tiers,
             "sample_bytes_equal": True, "device_rows_used": used,
             "resident_device_rows": resident_rows,
             "tiers_after_stream": st_stream, "tiers": st,
             "transition_ms": rm.latency_ms((50, 99)), "ladder": ladder,
             "card": card})
    finally:
        tiered.shutdown()
        if resident is not None:
            resident.shutdown()
        shutil.rmtree(blob_dir, ignore_errors=True)


def phase_nearcache(rng, card: str) -> None:
    """10b: bench.py bench_nearcache_hotkeys' shape at config 1's filter."""
    client = p10_client()
    try:
        bf = client.get_bloom_filter("p10-nc")
        check(bf.try_init(1_000_000, 0.01), "try_init refused")
        loaded = np.arange(P10["nc_keys"], dtype=np.uint64)
        bf.add_all(loaded)
        g = golden_bloom(bf, loaded)
        nc = client._engine.nearcache
        n = P10["nc_reads"]
        reads = (rng.zipf(1.3, 2 * n) % (2 * P10["nc_keys"])).astype(np.uint64)

        def run():
            answers = [bf.contains(k) for k in reads[:n]]  # warm
            h0, m0 = nc.hits, nc.misses
            lat = np.empty(n)
            t0 = time.perf_counter()
            for i, k in enumerate(reads[n:]):
                s = time.perf_counter()
                answers.append(bf.contains(k))
                lat[i] = time.perf_counter() - s
            dt = time.perf_counter() - t0
            hits, misses = nc.hits - h0, nc.misses - m0
            return answers, {"ops_per_s": n / dt, "p50_us": float(np.percentile(lat, 50)) * 1e6,
                             "p99_us": float(np.percentile(lat, 99)) * 1e6,
                             "hit_rate": hits / max(1, hits + misses)}

        on, on_stats = run()
        nc.set_enabled(False)
        off, off_stats = run()
        nc.set_enabled(True)
        check(on == off, "answers differ with the near cache on and off")
        check(np.array_equal(np.asarray(on), golden_contains(g, reads)),
              "near-cache answers differ from golden")
        ghost = np.uint64(1 << 41)
        check(bf.contains(ghost) is False and bf.contains(ghost) is False, "ghost present")
        h0 = nc.hits
        check(bf.contains(ghost) is False and nc.hits == h0 + 1, "the negative was not cached")
        check(bf.add(ghost) is True, "ghost add")
        check(bf.contains(ghost) is True, "a cached negative outlived the add")
        log({"phase": "10b", "config": "bloom 1M keys 1% FPP, 100,000 added",
             "reads": n, "zipf": 1.3, "cache_on": on_stats, "cache_off": off_stats,
             "answers_equal": True, "negative_retired_by_add": True, "card": card})
    finally:
        client.shutdown()


def p10c_child(mode: str) -> int:
    """10c in a fresh process: first-batch latency per bucket with pre-warm
    (``warm``) or without (``cold``); prints one JSON line."""
    from redisson_tpu_torch.executor import prewarm

    rng = np.random.default_rng(100)
    client = p10_client(prewarm=mode == "warm")
    try:
        bf = client.get_bloom_filter("p10c-bf")
        bf.try_init(1_000_000, 0.01)
        bf.add(np.uint64(0))  # the first submit reveals the codec's ladder
        bs = client.get_bit_set("p10c-bs")
        bs.set(1 << 20)
        hll = client.get_hyper_log_log("p10c-hll")
        hll.add(np.uint64(0))
        cms = client.get_count_min_sketch("p10c-cms")
        cms.try_init(5, 1 << 16)
        t0 = time.perf_counter()
        drained = client.prewarm_wait(600)
        wait_s = time.perf_counter() - t0
        cfg = client.config.gpu_sketch
        ladder, b = [], cfg.min_bucket
        while b <= cfg.max_batch:
            ladder.append(b)
            b *= 2
        before = prewarm.first_launch_count()
        first_ms = {"bloom": {}, "bitset": {}, "hll": {}, "cms": {}}
        for b in ladder:
            keys = rng.integers(0, 1 << 40, b, dtype=np.uint64)
            idx = rng.integers(0, 1 << 20, b)
            for kind, op in (("bloom", lambda: bf.add_all_async(keys)),
                             ("bitset", lambda: bs.set_many_async(idx, True)),
                             ("hll", lambda: hll.add_all_async(keys)),
                             ("cms", lambda: cms.add_all_async(keys))):
                torch.cuda.synchronize()
                s = time.perf_counter()
                op().result()
                torch.cuda.synchronize()
                first_ms[kind][b] = (time.perf_counter() - s) * 1e3
        after = prewarm.first_launch_count()
        pw = client._engine.prewarmer
        print(json.dumps({"mode": mode, "drained": drained, "prewarm_wait_s": wait_s,
                          "warmed": 0 if pw is None else pw.warmed,
                          "first_launches_before": before, "first_launches_after": after,
                          "first_batch_ms": first_ms}), flush=True)
    finally:
        client.shutdown()
    return 0


def phase_prewarm(card: str) -> None:
    """10c: each arm in its own process, so the cold one is really cold."""
    out = {}
    for mode in ("warm", "cold"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--p10c-child", mode], capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"10c {mode} arm failed:\n{proc.stderr[-4000:]}")
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    warm = out["warm"]
    check(warm["drained"] is True, "prewarm_wait did not drain")
    check(warm["first_launches_after"] == warm["first_launches_before"],
          f"{warm['first_launches_after'] - warm['first_launches_before']} first "
          f"launches after prewarm_wait")
    log({"phase": "10c", "warm": warm, "cold": out["cold"], "card": card})


def phase_bitset_past_2_31(card: str) -> None:
    """The BitSet contract past 2**31 bits (int64 end to end) on fresh
    2**32-bit BitSets, 512 MiB each on the card."""
    client = p10_client()
    try:
        got = {}
        bs = client.get_bit_set("p10-big")
        bs.set(2**31)
        got["length_after_set_2_31"] = bs.length()
        bs.set(2**32 - 1)
        got["length_after_set_2_32_minus_1"] = bs.length()
        bs2 = client.get_bit_set("p10-big2")
        bs2.set(3 * 2**30)
        got["first_set_bit_after_set_3_2_30"] = bs2.first_set_bit()
        bs3 = client.get_bit_set("p10-big3")
        bs3.set_range(2**31 - 64, 2**31 + 64)
        got["cardinality_after_set_range"] = bs3.cardinality()
        want = {"length_after_set_2_31": 2147483649,
                "length_after_set_2_32_minus_1": 4294967296,
                "first_set_bit_after_set_3_2_30": 3221225472,
                "cardinality_after_set_range": 128}
        check(got == want, f"BitSet past 2**31: {got}")
        log({"phase": "10-bitset", **got, "card": card})
    finally:
        client.shutdown()


def phase_nearcache_tenants(card: str) -> None:
    """10d: phase 3's 1000-tenant run (reads of 256 keys, under the near
    cache's 1024-key cutoff) on fresh clients with the near cache on and
    off, in turns: what the default costs reads the cache rarely hits."""
    rates = {"on": [], "off": []}
    for arm in ("on", "off", "off", "on"):
        client = p10_client(nearcache=arm == "on")
        try:
            rates[arm].append(phase_tenants(client, np.random.default_rng(3),
                                            phase=f"10d-{arm}"))
        finally:
            client.shutdown()
    log({"phase": "10d", "ops_per_s": rates, "card": card})


def phase_tiers(rng, card: str) -> None:
    log({"phase": 10, "sizes": P10, "card": card})
    phase_tiered(rng, card)
    phase_nearcache(rng, card)
    phase_nearcache_tenants(card)
    phase_prewarm(card)
    phase_bitset_past_2_31(card)


# -- phase 11: the RESP front door ---------------------------------------------

P11 = {"keys": 1 << 20, "madd": 1024, "conns": 4, "window": 16,
       "read": 131_072, "mexists": 1024, "fpp": 0.01, "capacity": 1_000_000,
       "c6_conns": 4, "c6_depth": 256, "c6_batches": 8, "c6_items": 512,
       "c6_filter": 100_000,
       "c8_idle": 1000, "c8_active": 32, "c8_procs": 8, "c8_pass_s": 3.0,
       "c8_items": 512}
P11_DEVICE = "cuda"


def wire(cmds) -> bytes:
    from redisson_tpu_torch.serve.wireutil import wire_command

    return b"".join(wire_command(c) for c in cmds)


def read_frames(sock, n: int, timeout: float = 300.0) -> list:
    """Exactly ``n`` complete reply frames from ``sock``, as bytes."""
    from redisson_tpu_torch.serve.wireutil import skip_reply_frame

    sock.settimeout(timeout)
    buf, out, pos = b"", [], 0
    while True:
        try:
            while len(out) < n:
                end = skip_reply_frame(buf, pos)
                out.append(buf[pos:end])
                pos = end
        except (IndexError, ValueError):
            pass
        if len(out) >= n:
            check(pos == len(buf), "extra reply bytes after the expected frames")
            return out
        chunk = sock.recv(1 << 20)
        check(bool(chunk), f"connection closed after {len(out)} of {n} replies")
        buf += chunk


def roundtrip(server, cmds) -> list:
    import socket

    s = socket.create_connection((server.host, server.port))
    try:
        s.sendall(wire(cmds))
        return read_frames(s, len(cmds))
    finally:
        s.close()


def int_array(frame: bytes) -> np.ndarray:
    """The integers of a RESP array reply of integers."""
    parts = frame.split(b"\r\n")
    check(parts[0][:1] == b"*", f"not an array reply: {frame[:40]!r}")
    n = int(parts[0][1:])
    check(all(p[:1] == b":" for p in parts[1:1 + n]), "not an integer array")
    return np.array([int(p[1:]) for p in parts[1:1 + n]], np.int64)


def p11_client(**kw):
    import redisson_tpu_torch as rt

    return rt.create(rt.Config().use_gpu_sketch(device=P11_DEVICE, **kw))


def p11_server(client):
    from redisson_tpu_torch.serve.resp import RespServer

    return RespServer(client, max_connections=4096)


def wire_hashes(client, items, m: int):
    """(h1 mod m, h2 mod m) of wire items as the server hashes them: the
    client codec's bytes, murmur3 x86-128."""
    from redisson_tpu_torch import codecs
    from redisson_tpu_torch.utils import hashing

    return hashing.km_reduce_mod(
        *hashing.hash128_np(*codecs.encode_batch(client.config.codec, items)), m)


def c11_keys(lo: int, hi: int) -> list:
    return [b"%d" % i for i in range(lo, hi)]


def phase_wire_bloom(rng, card: str) -> None:
    """11a: config 1 over the wire at full size."""
    import socket

    from redisson_tpu_torch.ops import golden

    n, per, conns = P11["keys"], P11["madd"], P11["conns"]
    client = p11_client()
    server = p11_server(client)
    try:
        check(roundtrip(server, [[b"BF.RESERVE", b"cfg1", b"%g" % P11["fpp"],
                                  b"%d" % P11["capacity"]]]) == [b"+OK\r\n"],
              "BF.RESERVE refused")
        bf = client.get_bloom_filter("cfg1")
        m, k = bf.get_size(), bf.get_hash_iterations()
        # Warm-up on a filter of the same size class (first launches of
        # each op, the reactor's first ticks) outside the timed window.
        roundtrip(server, [[b"BF.RESERVE", b"warm", b"%g" % P11["fpp"],
                            b"%d" % P11["capacity"]]]
                  + [[b"BF.MADD", b"warm"] + c11_keys(i * per, (i + 1) * per)
                     for i in range(8)]
                  + [[b"BF.MEXISTS", b"warm"] + c11_keys(i * per, (i + 1) * per)
                     for i in range(8)])
        n_cmds = n // per
        # Connection c sends commands c, c + conns, ... in pipelined windows.
        streams = [[[b"BF.MADD", b"cfg1"] + c11_keys(j * per, (j + 1) * per)
                    for j in range(c, n_cmds, conns)] for c in range(conns)]
        payloads = [[wire(s[i:i + P11["window"]]) for i in range(0, len(s), P11["window"])]
                    for s in streams]
        replies = [None] * conns
        errors = []

        def load(c):
            try:
                sock = socket.create_connection((server.host, server.port))
                out = []
                for i, p in enumerate(payloads[c]):
                    sock.sendall(p)
                    out += read_frames(sock, min(P11["window"], len(streams[c]) - i * P11["window"]))
                sock.close()
                replies[c] = out
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        add_s = time.perf_counter() - t0
        check(not errors, f"wire load failed: {errors[:1]}")
        # Golden model: the flags of one connection's commands depend on
        # the other connections' adds only through the interleaving.  A
        # reply is right when it lies between the two orders the golden
        # model bounds it by: 1 only if the key's bits were not all set by
        # the earlier keys of its own connection (a sequential golden
        # filter per connection), and 0 only if every one of its bits is
        # set by some OTHER key of the whole load.
        h1, h2 = wire_hashes(client, c11_keys(0, n), m)
        g = golden.GoldenBloomFilter(m, k)
        idx = g._indexes(h1, h2)
        hits = np.bincount(idx.reshape(-1).astype(np.int64), minlength=m)
        own = np.zeros((n, k), np.int64)  # a key's own hits on each of its bits
        for j in range(k):
            same = idx == idx[:, j:j + 1]
            own[:, j] = same.sum(axis=1)
        covered_by_others = np.all(hits[idx.astype(np.int64)] - own > 0, axis=1)
        n_added = 0
        for c in range(conns):
            seq = golden.GoldenBloomFilter(m, k)
            keys = np.concatenate([np.arange(j * per, (j + 1) * per)
                                   for j in range(c, n_cmds, conns)])
            upper = seq.add_hashed(h1[keys], h2[keys])
            flags = np.concatenate([int_array(f) for f in replies[c]])
            check(flags.shape == keys.shape and np.isin(flags, (0, 1)).all(),
                  "BF.MADD replies malformed")
            check(np.all(flags <= upper), "BF.MADD reported a key new whose bits "
                  "its own connection had already set")
            check(np.all(flags >= ~covered_by_others[keys]), "BF.MADD reported a "
                  "key present whose bits no other key sets")
            n_added += int(flags.sum())
        check(0.97 * n <= n_added <= n, f"added {n_added} of {n}")
        g.bits[idx.reshape(-1)] = True
        words = tenant_row(client, "cfg1")
        gbits = np.zeros(words.shape[0] * 32, bool)
        gbits[:m] = g.bits
        check(np.array_equal(words, np.packbits(gbits, bitorder="little").view(np.uint32)),
              "11a: filter row differs from the golden bitmap")
        # Read: keys outside the loaded set, BF.MEXISTS over 4 connections.
        outside = rng.integers(3 * n, 8 * n, P11["read"])
        items = [b"%d" % v for v in outside]
        per_r = P11["mexists"]
        cmds = [[b"BF.MEXISTS", b"cfg1"] + items[i:i + per_r]
                for i in range(0, len(items), per_r)]
        rstreams = [cmds[c::conns] for c in range(conns)]
        rreplies = [None] * conns

        def read(c):
            try:
                sock = socket.create_connection((server.host, server.port))
                out = []
                for i in range(0, len(rstreams[c]), P11["window"]):
                    part = rstreams[c][i:i + P11["window"]]
                    sock.sendall(wire(part))
                    out += read_frames(sock, len(part))
                sock.close()
                rreplies[c] = out
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=read, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        read_s = time.perf_counter() - t0
        check(not errors, f"wire read failed: {errors[:1]}")
        o1, o2 = wire_hashes(client, items, m)
        want = g.contains_hashed(o1, o2)
        got = np.zeros(len(items), bool)
        for c in range(conns):
            for j, f in enumerate(rreplies[c]):
                lo = (c + j * conns) * per_r
                got[lo:lo + per_r] = int_array(f).astype(bool)
        check(np.array_equal(got, want), "11a: BF.MEXISTS differs from golden")
        fpp = float(got.mean())
        p_theory = (1.0 - np.exp(-k * n / m)) ** k
        sigma = np.sqrt(p_theory * (1.0 - p_theory) / len(items))
        check(abs(fpp - p_theory) <= 3 * sigma,
              f"11a: FPP {fpp} vs expected {p_theory} +- {3 * sigma}")
        check_healthy(client, "11a")
        log({"phase": "11a", "config": "bloom 1M keys 1% FPP over RESP",
             "connections": conns, "madd_keys_per_cmd": per,
             "wire_add_ops_per_s": n / add_s, "wire_contains_ops_per_s": len(items) / read_s,
             "added": n_added, "fpp": fpp, "fpp_expected": p_theory,
             "fpp_3sigma": 3 * sigma, "row_equals_golden": True,
             "native_parser": bool(server.reactor and server.reactor.native_tick),
             "card": card})
    finally:
        server.close()
        client.shutdown()


def config6_seed_cmds() -> list:
    """Config 6's keyspace: the 100,000-key / 1% filter holding the even
    hot items, four strings, a bitmap with its even offsets set."""
    n_items = P11["c6_items"]
    cmds = [[b"BF.RESERVE", b"fd-bf", b"0.01", b"%d" % P11["c6_filter"]]]
    cmds += [[b"BF.MADD", b"fd-bf"] + [b"%d" % i for i in range(j, min(j + 64, n_items), 2)]
             for j in range(0, n_items, 64)]
    cmds += [[b"SET", b"fd-s%d" % i, b"value-%d" % i] for i in range(4)]
    cmds += [[b"SETBIT", b"fd-bs", b"%d" % i, b"1"] for i in range(0, 64, 2)]
    return cmds


def config6_batches(seed: int, n_batches: int, depth: int) -> list:
    """Config 6's pipelined traffic (``bench.py::bench_config6_frontdoor``):
    spans of 16-48 commands on one family — Bloom 0.5 (15% BF.ADD among
    BF.EXISTS), strings 0.3 (4% SET among GET), bitmap 0.2 (20% SETBIT
    among GETBIT) — over zipf(1.3) keys on 512 hot items.  A SET writes
    its key's seed value, so what a GET returns does not depend on how
    the connections interleave."""
    rng = np.random.default_rng(seed)
    n_items = P11["c6_items"]
    out = []
    for _ in range(n_batches):
        cmds = []
        while len(cmds) < depth:
            burst = min(int(rng.integers(16, 49)), depth - len(cmds))
            hot = (rng.zipf(1.3, burst) - 1) % n_items
            fam = rng.random()
            for i in range(burst):
                w = rng.random()
                if fam < 0.5:
                    op = b"BF.ADD" if w < 0.15 else b"BF.EXISTS"
                    cmds.append([op, b"fd-bf", b"%d" % hot[i]])
                elif fam < 0.8:
                    key = int(hot[i]) % 4
                    cmds.append([b"SET", b"fd-s%d" % key, b"value-%d" % key] if w < 0.04
                                else [b"GET", b"fd-s%d" % key])
                else:
                    off = b"%d" % (hot[i] % 64)
                    cmds.append([b"SETBIT", b"fd-bs", off, b"1"] if w < 0.2
                                else [b"GETBIT", b"fd-bs", off])
        out.append(cmds)
    return out


def config6_pass(server, batches_per_conn) -> tuple:
    """One pass: connection c streams its batches, one pipelined batch in
    flight at a time.  Returns (reply bytes per connection, seconds)."""
    import socket

    conns = len(batches_per_conn)
    payloads = [[wire(b) for b in bs] for bs in batches_per_conn]
    out = [None] * conns
    errors = []

    def worker(c):
        try:
            sock = socket.create_connection((server.host, server.port))
            got = []
            for b, p in zip(batches_per_conn[c], payloads[c]):
                sock.sendall(p)
                got += read_frames(sock, len(b))
            sock.close()
            out[c] = b"".join(got)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    check(not errors, f"config 6 pass failed: {errors[:1]}")
    return out, dt


def frontdoor_totals(server) -> dict:
    from redisson_tpu_torch.obs import total

    o = server.obs
    return {"fused": total(o.resp_fused_cmds), "cmds": total(o.resp_commands),
            "hits": total(o.resp_cache_hits), "misses": total(o.resp_cache_misses)}


def device_idle_share(fn, name: str = "frontdoor") -> dict:
    """Wall, device busy (the union of the kernel and memcpy intervals the
    profiler saw) and idle share of one call of ``fn``; None where the
    profiler saw no device activity."""
    import profile_port

    if P11_DEVICE != "cuda":
        return {"wall_ms": None, "device_busy_ms": None, "idle_share": None}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    row = profile_port.profile_pass(name, fn, out_dir, warm=False)
    return {k: row[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                "top_device_ms")}


def phase_config6(card: str, seed: int) -> None:
    """11b: config 6's stream on a vectorizing and a sequential server."""
    P, depth, nb = P11["c6_conns"], P11["c6_depth"], P11["c6_batches"]
    batches = config6_batches(seed, P * nb, depth)
    per_conn = [batches[c * nb:(c + 1) * nb] for c in range(P)]
    arms = {}
    for vec in (True, False):
        client = p11_client(batch_window_us=200)
        client.config.resp_vectorize = vec
        server = p11_server(client)
        try:
            roundtrip(server, config6_seed_cmds())
            config6_pass(server, per_conn)  # warm: every write of the stream lands once
            before = frontdoor_totals(server)
            replies, dt = config6_pass(server, per_conn)
            after = frontdoor_totals(server)
            d = {k: after[k] - before[k] for k in after}
            prof = device_idle_share(lambda: config6_pass(server, per_conn)) if vec else None
            check_healthy(client, "11b")
            arms[vec] = {"replies": replies, "dt": dt, "d": d, "prof": prof,
                         "rows": (tenant_row(client, "fd-bf"), tenant_row(client, "fd-bs"))}
        finally:
            server.close()
            client.shutdown()
    for c in range(P):
        check(arms[True]["replies"][c] == arms[False]["replies"][c],
              f"11b: connection {c}'s replies differ between the arms")
    for a, b in zip(arms[True]["rows"], arms[False]["rows"]):
        check(np.array_equal(a, b), "11b: rows differ between the arms")
    n_cmds = P * nb * depth
    d = arms[True]["d"]
    log({"phase": "11b", "config": "config 6 front door", "connections": P,
         "depth": depth, "batches_per_conn": nb, "cmds": n_cmds,
         "cmds_per_s": n_cmds / arms[True]["dt"],
         "unfused_cmds_per_s": n_cmds / arms[False]["dt"],
         "fusion_ratio": d["fused"] / d["cmds"] if d["cmds"] else 0.0,
         "response_cache_hit_rate": d["hits"] / (d["hits"] + d["misses"])
         if d["hits"] + d["misses"] else 0.0,
         "replies_equal": True, "rows_equal": True,
         "profile_one_pass": arms[True]["prof"], "card": card})


def config8_seed_cmds() -> list:
    n_items = P11["c8_items"]
    cmds = [[b"BF.RESERVE", b"rx-bf", b"0.01", b"100000"]]
    cmds += [[b"BF.MADD", b"rx-bf"] + [b"%d" % i for i in range(j, j + 64)]
             for j in range(0, n_items, 64)]
    cmds += [[b"SET", b"rx-s%d" % i, b"value-%d" % i] for i in range(4)]
    cmds += [[b"SETBIT", b"rx-bs", b"%d" % i, b"1"] for i in range(0, 64, 2)]
    for _ in range(3):  # the fused paths' first launches, outside the passes
        cmds += [[b"BF.EXISTS", b"rx-bf", b"%d" % i] for i in range(32)]
        cmds += [[b"BF.ADD", b"rx-bf", b"%d" % i] if i % 4 == 0 else
                 [b"BF.EXISTS", b"rx-bf", b"%d" % i] for i in range(32)]
        cmds += [[b"GETBIT", b"rx-bs", b"%d" % (i % 64)] for i in range(32)]
        cmds += [[b"GET", b"rx-s%d" % (i % 4)] for i in range(16)]
    return cmds


def config8_command(rng) -> list:
    """One command of config 8's closed-loop clients
    (``bench.py::bench_config8_reactor``): 3% BF.ADD, 35% BF.EXISTS, 50%
    GET, the rest GETBIT, over zipf(1.3) on 512 hot items."""
    hot = int((rng.zipf(1.3) - 1) % P11["c8_items"])
    r = rng.random()
    if r < 0.03:
        return [b"BF.ADD", b"rx-bf", b"%d" % hot]
    if r < 0.38:
        return [b"BF.EXISTS", b"rx-bf", b"%d" % hot]
    if r < 0.88:
        return [b"GET", b"rx-s%d" % (hot % 4)]
    return [b"GETBIT", b"rx-bs", b"%d" % (hot % 64)]


def config8_client_proc(host, port, conns, seconds, seed, q):
    """Closed-loop single-command clients in a child process (so the
    clients do not share the server's interpreter): one thread per
    connection, one command in flight.  Puts (count, seconds, latencies,
    the distinct (command, reply) pairs seen)."""
    import socket

    counts = [0] * conns
    lats = [[] for _ in range(conns)]
    seen = [dict() for _ in range(conns)]

    def worker(t):
        rng = np.random.default_rng(seed * 100 + t)
        sock = socket.create_connection((host, port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stop = time.perf_counter() + seconds
        try:
            while time.perf_counter() < stop:
                cmd = config8_command(rng)
                t0 = time.perf_counter()
                sock.sendall(wire([cmd]))
                rep = read_frames(sock, 1, timeout=60.0)[0]
                lats[t].append(time.perf_counter() - t0)
                counts[t] += 1
                seen[t].setdefault(tuple(cmd), set()).add(rep)
        finally:
            sock.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(conns)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pairs = {}
    for s in seen:
        for k, v in s.items():
            pairs.setdefault(k, set()).update(v)
    q.put((sum(counts), time.perf_counter() - t0, [x for la in lats for x in la],
           {k: sorted(v) for k, v in pairs.items()}))


def serving_threads() -> int:
    return sum(1 for t in threading.enumerate() if t.name.startswith("rtpu-resp"))


def open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def phase_config8(card: str, seed: int) -> None:
    """11c: config 8's traffic, reactor against thread-per-connection."""
    import multiprocessing as mp
    import resource
    import socket

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    # Both ends of an idle connection live in this process: 2 fds each.
    idle_n = min(P11["c8_idle"], max(0, (soft - 512) // 2))
    ctx = mp.get_context("spawn")
    out = {}
    for arm in (True, False):
        client = p11_client(batch_window_us=200)
        client.config.resp_reactor = arm
        server = p11_server(client)
        idle = []
        try:
            roundtrip(server, config8_seed_cmds())
            threads_base = serving_threads()  # before any idle connection
            for _ in range(idle_n):
                idle.append(socket.create_connection((server.host, server.port), timeout=10))
            threads_idle = serving_threads()

            def measure(seconds):
                q = ctx.Queue()
                per = P11["c8_active"] // P11["c8_procs"]
                procs = [ctx.Process(target=config8_client_proc,
                                     args=(server.host, server.port, per, seconds, seed + i, q))
                         for i in range(P11["c8_procs"])]
                for p in procs:
                    p.start()
                res = [q.get(timeout=seconds + 120) for _ in procs]
                for p in procs:
                    p.join(timeout=30)
                return res

            measure(1.0)  # warm
            threads_loaded = serving_threads()
            res = measure(P11["c8_pass_s"])
            total = sum(r[0] for r in res)
            dt = float(np.median([r[1] for r in res]))
            lat = np.sort(np.concatenate([np.asarray(r[2]) for r in res]))
            pairs = {}
            for r in res:
                for k, v in r[3].items():
                    pairs.setdefault(k, set()).update(v)
            # Every distinct command got one reply only, equal to a
            # sequential replay on one connection.
            cmds = sorted(pairs)
            check(all(len(v) == 1 for v in pairs.values()),
                  "11c: one command got different replies")
            replay = roundtrip(server, [list(c) for c in cmds])
            check(all(pairs[c] == {r} for c, r in zip(cmds, replay)),
                  "11c: replies differ from a sequential replay")
            nthreads = server.reactor.nthreads if server.reactor is not None else 0
            if arm:
                # Fixed: the same serving threads (the reactor's and the
                # accept thread) however many connections are open.
                check(threads_idle == threads_base and threads_loaded <= threads_base + 1,
                      f"11c: serving threads {threads_base} -> {threads_idle} idle, "
                      f"{threads_loaded} loaded, with a reactor of {nthreads}")
            check_healthy(client, "11c")
            out["reactor" if arm else "reactor_off"] = {
                "cmds_per_s": total / dt, "p50_ms": float(lat[len(lat) // 2] * 1e3),
                "p99_ms": float(lat[int(len(lat) * 0.99)] * 1e3),
                "serving_threads_before_conns": threads_base,
                "serving_threads_idle": threads_idle,
                "serving_threads_loaded": threads_loaded,
                "process_fds": open_fds(), "distinct_cmds": len(cmds)}
        finally:
            for s in idle:
                s.close()
            server.close()
            client.shutdown()
    log({"phase": "11c", "config": "config 8 reactor", "idle_conns": idle_n,
         "idle_target": P11["c8_idle"], "active_conns": P11["c8_active"],
         "fd_soft_limit": soft, **out, "card": card})


def c11d_boot(port: int, sdir: str):
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    return subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port),
         "--device", P11_DEVICE, "--snapshot-dir", sdir],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def c11d_connect(port: int, proc, timeout: float = 180.0):
    import socket

    t0 = time.perf_counter()
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=120)
        except OSError:
            if proc.poll() is not None:
                fail(f"server exited: {proc.communicate()[0][-2000:]}")
            check(time.perf_counter() - t0 < timeout, "server did not start")
            time.sleep(0.2)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


C11D_WRITES = [
    [b"PING"], [b"SET", b"cli-k", b"v"], [b"INCR", b"cli-n"], [b"INCR", b"cli-n"],
    [b"BF.RESERVE", b"cli-bf", b"0.01", b"1000"], [b"BF.ADD", b"cli-bf", b"alpha"],
    [b"BF.EXISTS", b"cli-bf", b"alpha"], [b"PFADD", b"cli-h", b"a", b"b", b"c"],
    [b"PFCOUNT", b"cli-h"], [b"SETBIT", b"cli-bs", b"77", b"1"],
    [b"GETBIT", b"cli-bs", b"77"], [b"CMS.INITBYDIM", b"cli-cms", b"1024", b"4"],
    [b"CMS.INCRBY", b"cli-cms", b"x", b"5", b"y", b"2"], [b"CMS.QUERY", b"cli-cms", b"x", b"y"],
    [b"TOPK.RESERVE", b"cli-tk", b"2"], [b"TOPK.ADD", b"cli-tk", b"a", b"b", b"a", b"c", b"a"],
    [b"TOPK.LIST", b"cli-tk", b"WITHCOUNT"],
]
C11D_READS = [
    [b"GET", b"cli-k"], [b"GET", b"cli-n"], [b"BF.EXISTS", b"cli-bf", b"alpha"],
    [b"BF.EXISTS", b"cli-bf", b"nope"], [b"PFCOUNT", b"cli-h"], [b"GETBIT", b"cli-bs", b"77"],
    [b"GETBIT", b"cli-bs", b"78"], [b"CMS.QUERY", b"cli-cms", b"x", b"y", b"z"],
    [b"TOPK.LIST", b"cli-tk", b"WITHCOUNT"], [b"DBSIZE"], [b"TYPE", b"cli-bf"],
]


def phase_entry_point(card: str) -> None:
    """11d: ``python -m redisson_tpu_torch`` boots, serves, drains and
    snapshots on SIGTERM, and a reboot on the same directory answers every
    read as before."""
    import signal

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="phase11d-", dir=str(build))
    try:
        answers = []
        for boot in range(2):
            port = free_port()
            t0 = time.perf_counter()
            proc = c11d_boot(port, sdir)
            try:
                sock = c11d_connect(port, proc)
                boot_s = time.perf_counter() - t0
                if boot == 0:
                    sock.sendall(wire(C11D_WRITES))
                    w = read_frames(sock, len(C11D_WRITES))
                    check(not any(f.startswith(b"-") for f in w), f"11d: write failed: {w}")
                sock.sendall(wire(C11D_READS + [[b"INFO", b"server"]]))
                r = read_frames(sock, len(C11D_READS) + 1)
                sock.close()
                info = r[-1].decode()
                check(f"rtpu_device:{P11_DEVICE}" in info, f"11d: INFO server: {info}")
                if P11_DEVICE == "cuda":
                    check(torch.cuda.get_device_name(0) in info, "11d: INFO lacks the card")
                answers.append(r[:-1])
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=180)
                check(proc.returncode == 0, f"11d: exit {proc.returncode}: {out[-2000:]}")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=30)
            if boot == 0:
                check(os.path.exists(os.path.join(sdir, "grid_store.bin")),
                      "11d: no grid_store.bin after SIGTERM")
                first_boot_s = boot_s
        check(answers[0] == answers[1], f"11d: reboot answers differ: {answers}")
        check(answers[0][0] == b"$1\r\nv\r\n" and answers[0][1] == b"$1\r\n2\r\n"
              and answers[0][2] == b":1\r\n", f"11d: wrong answers {answers[0]}")
        log({"phase": "11d", "entry_point": "python -m redisson_tpu_torch",
             "boot_s": first_boot_s, "reboot_s": boot_s, "reads": len(C11D_READS),
             "reads_equal_after_restart": True, "info_server_card": True, "card": card})
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def phase_frontdoor(rng, seed: int, card: str) -> None:
    os.environ["RTPU_REQUIRE_NATIVE_RESP"] = "1"
    from redisson_tpu_torch.serve import native_codec

    check(native_codec.get_parser() is not None and native_codec.get_ticker() is not None,
          "the native RESP codec did not build")
    phase_wire_bloom(rng, card)
    phase_config6(card, seed)
    phase_config8(card, seed)
    phase_entry_point(card)


# -- phase 12: the data grid, the RTopic -> CMS pipe, pub/sub, blocking pops ---

P12 = {"events": 16_000_000, "msg": 1 << 15, "keys": 100_000, "d": 5, "w": 1 << 16,
       "top_k": 20, "batch_size": 1 << 15, "flush_s": 0.05, "pipeline": 1000}
P12_DEVICE = "cuda"

# The grid session of 12b: lists, hashes, sets, sorted sets (SCAN family,
# STORE commands), streams with a consumer group, geo, WRONGTYPE between a
# Bloom key and a list key.  bytes = the literal Redis reply (the pairs of
# tests/test_resp_wire_fixtures.py and Redis's documented GEO replies);
# None = equal to the CPU server's bytes only; ("prefix", p) / ("shape", p)
# = both replies start with p (error codes; random picks and idle times).
P12_GRID = [
    # the literal pairs of tests/test_resp_wire_fixtures.py
    ([b"RPUSH", b"l", b"a", b"b"], b":2\r\n"),
    ([b"LPUSH", b"l", b"z"], b":3\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], b"*3\r\n$1\r\nz\r\n$1\r\na\r\n$1\r\nb\r\n"),
    ([b"LPOP", b"l"], b"$1\r\nz\r\n"),
    ([b"LLEN", b"l"], b":2\r\n"),
    ([b"HSET", b"h", b"f1", b"v1"], b":1\r\n"),
    ([b"HGET", b"h", b"f1"], b"$2\r\nv1\r\n"),
    ([b"HEXISTS", b"h", b"f1"], b":1\r\n"),
    ([b"HLEN", b"h"], b":1\r\n"),
    ([b"SADD", b"s", b"a", b"b"], b":2\r\n"),
    ([b"SISMEMBER", b"s", b"a"], b":1\r\n"),
    ([b"SISMEMBER", b"s", b"q"], b":0\r\n"),
    ([b"SCARD", b"s"], b":2\r\n"),
    ([b"ZADD", b"z", b"1.5", b"m"], b":1\r\n"),
    ([b"ZSCORE", b"z", b"m"], b"$3\r\n1.5\r\n"),
    ([b"ZCARD", b"z"], b":1\r\n"),
    ([b"HSET", b"s", b"f"], ("prefix", b"-ERR")),
    ([b"LPOP", b"h"], ("prefix", b"-WRONGTYPE")),
    # lists
    ([b"RPUSH", b"l", b"c", b"a", b"d"], b":5\r\n"),
    ([b"LINDEX", b"l", b"-1"], b"$1\r\nd\r\n"),
    ([b"LINDEX", b"l", b"99"], b"$-1\r\n"),
    ([b"LSET", b"l", b"1", b"B"], b"+OK\r\n"),
    ([b"LSET", b"l", b"99", b"B"], ("prefix", b"-ERR")),
    ([b"LPOS", b"l", b"a"], b":0\r\n"),
    ([b"LPOS", b"l", b"a", b"RANK", b"2"], b":3\r\n"),
    ([b"LPOS", b"l", b"a", b"COUNT", b"0"], b"*2\r\n:0\r\n:3\r\n"),
    ([b"LREM", b"l", b"1", b"a"], b":1\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], None),
    ([b"LTRIM", b"l", b"0", b"2"], b"+OK\r\n"),
    ([b"LPUSHX", b"l", b"x"], b":4\r\n"),
    ([b"RPUSHX", b"nolist", b"x"], b":0\r\n"),
    ([b"RPOPLPUSH", b"l", b"l2"], None),
    ([b"LMOVE", b"l", b"l2", b"LEFT", b"RIGHT"], None),
    ([b"LRANGE", b"l2", b"0", b"-1"], None),
    ([b"RPOP", b"l"], None),
    ([b"RPOP", b"ghostlist"], b"$-1\r\n"),
    ([b"BLPOP", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\na\r\n"),
    ([b"BRPOP", b"emptyl", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\nx\r\n"),
    ([b"TYPE", b"l"], b"+list\r\n"),
    # hashes
    ([b"HSET", b"h", b"f2", b"v2", b"f3", b"v3"], b":2\r\n"),
    ([b"HMGET", b"h", b"f1", b"nope", b"f3"], b"*3\r\n$2\r\nv1\r\n$-1\r\n$2\r\nv3\r\n"),
    ([b"HGETALL", b"h"], None),
    ([b"HKEYS", b"h"], None),
    ([b"HVALS", b"h"], None),
    ([b"HSETNX", b"h", b"f1", b"x"], b":0\r\n"),
    ([b"HSETNX", b"h", b"f4", b"x"], b":1\r\n"),
    ([b"HINCRBY", b"h", b"n", b"5"], b":5\r\n"),
    ([b"HINCRBY", b"h", b"n", b"-2"], b":3\r\n"),
    ([b"HINCRBY", b"h", b"f1", b"1"], ("prefix", b"-ERR")),
    ([b"HDEL", b"h", b"f4", b"nope"], b":1\r\n"),
    ([b"HSCAN", b"h", b"0", b"COUNT", b"100"], None),
    ([b"HSCAN", b"h", b"0", b"MATCH", b"f*", b"COUNT", b"1"], None),
    ([b"HSCAN", b"h", b"0", b"NOVALUES"], None),
    ([b"HRANDFIELD", b"h", b"-3"], ("shape", b"*3\r\n")),
    ([b"TYPE", b"h"], b"+hash\r\n"),
    # sets
    ([b"SADD", b"s2", b"b", b"c"], b":2\r\n"),
    ([b"SMISMEMBER", b"s", b"a", b"c"], b"*2\r\n:1\r\n:0\r\n"),
    ([b"SINTER", b"s", b"s2"], b"*1\r\n$1\r\nb\r\n"),
    ([b"SUNION", b"s", b"s2"], None),
    ([b"SDIFF", b"s", b"s2"], b"*1\r\n$1\r\na\r\n"),
    ([b"SINTERCARD", b"2", b"s", b"s2"], b":1\r\n"),
    ([b"SUNIONSTORE", b"su", b"s", b"s2"], b":3\r\n"),
    ([b"SDIFFSTORE", b"sd", b"s", b"s2"], b":1\r\n"),
    ([b"SINTERSTORE", b"si", b"s", b"s2"], b":1\r\n"),
    ([b"SMEMBERS", b"sd"], b"*1\r\n$1\r\na\r\n"),
    ([b"SMOVE", b"s", b"s2", b"a"], b":1\r\n"),
    ([b"SREM", b"s2", b"a", b"zz"], b":1\r\n"),
    ([b"SSCAN", b"su", b"0", b"COUNT", b"100"], None),
    ([b"SSCAN", b"su", b"0", b"MATCH", b"[ab]"], None),
    ([b"SRANDMEMBER", b"su", b"-2"], ("shape", b"*2\r\n")),
    ([b"SPOP", b"si"], b"$1\r\nb\r\n"),
    ([b"TYPE", b"su"], b"+set\r\n"),
    # sorted sets
    ([b"ZADD", b"z", b"2", b"n", b"3", b"o", b"0.25", b"p"], b":3\r\n"),
    ([b"ZRANGE", b"z", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZREVRANGE", b"z", b"0", b"1", b"WITHSCORES"], None),
    ([b"ZRANK", b"z", b"o"], b":3\r\n"),
    ([b"ZREVRANK", b"z", b"o"], b":0\r\n"),
    ([b"ZCOUNT", b"z", b"1", b"(3"], b":2\r\n"),
    ([b"ZRANGEBYSCORE", b"z", b"-inf", b"+inf", b"WITHSCORES", b"LIMIT", b"1", b"2"], None),
    ([b"ZINCRBY", b"z", b"0.5", b"m"], b"$1\r\n2\r\n"),
    ([b"ZADD", b"z2", b"10", b"m", b"20", b"q"], b":2\r\n"),
    ([b"ZUNIONSTORE", b"zu", b"2", b"z", b"z2", b"WEIGHTS", b"1", b"2"], b":5\r\n"),
    ([b"ZINTERSTORE", b"zi", b"2", b"z", b"z2", b"AGGREGATE", b"MAX"], b":1\r\n"),
    ([b"ZRANGE", b"zu", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZSCORE", b"zi", b"m"], b"$2\r\n10\r\n"),
    ([b"ZSCAN", b"zu", b"0", b"COUNT", b"100"], None),
    ([b"ZSCAN", b"zu", b"0", b"MATCH", b"m*"], None),
    ([b"ZADD", b"lex", b"0", b"a", b"0", b"b", b"0", b"c", b"0", b"d"], b":4\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"[b", b"(d"], b"*2\r\n$1\r\nb\r\n$1\r\nc\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"-", b"+", b"LIMIT", b"1", b"2"], None),
    ([b"ZRANDMEMBER", b"z", b"-2"], ("shape", b"*2\r\n")),
    ([b"ZPOPMIN", b"z"], b"*2\r\n$1\r\np\r\n$4\r\n0.25\r\n"),
    ([b"ZPOPMAX", b"z", b"2"], None),
    ([b"ZREMRANGEBYSCORE", b"zu", b"-inf", b"(20"], b":3\r\n"),
    ([b"ZREM", b"zu", b"q", b"zz"], b":1\r\n"),
    ([b"TYPE", b"z"], b"+zset\r\n"),
    # streams with a consumer group
    ([b"XADD", b"st", b"1-1", b"f", b"v1"], b"$3\r\n1-1\r\n"),
    ([b"XADD", b"st", b"2-0", b"f", b"v2", b"g", b"w"], b"$3\r\n2-0\r\n"),
    ([b"XADD", b"st", b"3-0", b"f", b"v3"], b"$3\r\n3-0\r\n"),
    ([b"XADD", b"st", b"1-0", b"f", b"bad"], ("prefix", b"-ERR")),
    ([b"XLEN", b"st"], b":3\r\n"),
    ([b"XRANGE", b"st", b"-", b"+"], None),
    ([b"XRANGE", b"st", b"-", b"+", b"COUNT", b"1"], None),
    ([b"XREVRANGE", b"st", b"+", b"-"], None),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], b"+OK\r\n"),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], ("prefix", b"-BUSYGROUP")),
    ([b"XREADGROUP", b"GROUP", b"g1", b"c1", b"COUNT", b"2", b"STREAMS", b"st", b">"], None),
    ([b"XPENDING", b"st", b"g1"], None),
    ([b"XPENDING", b"st", b"g1", b"-", b"+", b"10"],
     ("shape", b"*2\r\n*4\r\n$3\r\n1-1\r\n$2\r\nc1\r\n:")),
    ([b"XACK", b"st", b"g1", b"1-1"], b":1\r\n"),
    ([b"XACK", b"st", b"g1", b"1-1"], b":0\r\n"),
    ([b"XAUTOCLAIM", b"st", b"g1", b"c2", b"0", b"0"], None),
    ([b"XCLAIM", b"st", b"g1", b"c3", b"0", b"2-0"], None),
    ([b"XREAD", b"COUNT", b"10", b"STREAMS", b"st", b"1-1"], None),
    ([b"XINFO", b"STREAM", b"st"], None),
    ([b"XDEL", b"st", b"3-0"], b":1\r\n"),
    ([b"XTRIM", b"st", b"MAXLEN", b"1"], b":1\r\n"),
    ([b"XLEN", b"st"], b":1\r\n"),
    ([b"XREADGROUP", b"GROUP", b"nog", b"c1", b"STREAMS", b"st", b">"], ("prefix", b"-NOGROUP")),
    ([b"TYPE", b"st"], b"+stream\r\n"),
    # geo
    ([b"GEOADD", b"Sicily", b"13.361389", b"38.115556", b"Palermo",
      b"15.087269", b"37.502669", b"Catania"], b":2\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania"], b"$11\r\n166274.1516\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania", b"km"], b"$8\r\n166.2742\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Nowhere"], b"$-1\r\n"),
    ([b"GEOPOS", b"Sicily", b"Palermo", b"Nowhere"], None),
    ([b"GEOHASH", b"Sicily", b"Palermo", b"Catania"], b"*2\r\n$11\r\nsqc8b49rnyw\r\n$11\r\nsqdtr74hyu4\r\n"),
    ([b"GEOSEARCH", b"Sicily", b"FROMLONLAT", b"15", b"37", b"BYRADIUS",
      b"200", b"km", b"ASC", b"WITHCOORD", b"WITHDIST"], None),
    ([b"GEOSEARCH", b"Sicily", b"FROMMEMBER", b"Palermo", b"BYBOX",
      b"400", b"400", b"km", b"DESC", b"COUNT", b"1"], None),
    ([b"GEOSEARCHSTORE", b"near", b"Sicily", b"FROMLONLAT", b"15", b"37",
      b"BYRADIUS", b"100", b"km", b"STOREDIST"], b":1\r\n"),
    ([b"ZRANGE", b"near", b"0", b"-1", b"WITHSCORES"], None),
    ([b"GEOADD", b"Sicily", b"XX", b"CH", b"13.5", b"38.0", b"Palermo"], b":1\r\n"),
    ([b"GEOADD", b"Sicily", b"200", b"100", b"bad"], ("prefix", b"-ERR")),
    # one keyspace: WRONGTYPE between a Bloom key and a list key
    ([b"BF.RESERVE", b"bfk", b"0.01", b"100"], b"+OK\r\n"),
    ([b"LPUSH", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"SADD", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"BF.ADD", b"l2", b"x"], ("prefix", b"-ERR")),
    ([b"BF.RESERVE", b"l", b"0.01", b"100"], ("prefix", b"-WRONGTYPE")),
    ([b"HSET", b"s", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"XADD", b"h", b"*", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"GEOADD", b"l", b"1", b"1", b"m"], ("prefix", b"-WRONGTYPE")),
    ([b"SCAN", b"0", b"COUNT", b"1000"], None),
    ([b"DBSIZE"], b":17\r\n"),
    # transactions over the grid
    ([b"MULTI"], b"+OK\r\n"),
    ([b"RPUSH", b"tl", b"1", b"2"], b"+QUEUED\r\n"),
    ([b"HSET", b"th", b"f", b"v"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tl", b"0"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tnone", b"0"], b"+QUEUED\r\n"),
    ([b"EXEC"], b"*4\r\n:2\r\n:1\r\n*2\r\n$2\r\ntl\r\n$1\r\n1\r\n*-1\r\n"),
    ([b"MULTI"], b"+OK\r\n"),
    ([b"SUBSCRIBE", b"ch"], ("prefix", b"-ERR")),
    ([b"EXEC"], ("prefix", b"-EXECABORT")),
]


def p12_dispatch_counter(client):
    """Wrap the executor's ``cms_update_estimate`` (the dispatch the bridge's
    ``cms_add`` reaches through the coalescer): counts calls and ops."""
    ex = client._engine.executor
    orig = ex.cms_update_estimate
    seen = {"calls": 0, "ops": 0}

    def counted(pool, rows, *a, **kw):
        seen["calls"] += 1
        seen["ops"] += len(rows)
        return orig(pool, rows, *a, **kw)

    ex.cms_update_estimate = counted
    return seen


def phase_config5_pipe(card: str) -> dict:
    """12a: config 5 through its real pipe at bench_config5_stream_topk's
    shape: publish -> delivery pool -> TopicCmsBridge -> add_all_async ->
    cms_add -> coalescer -> cms_update_estimate on the card."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.serve import TopicCmsBridge
    from redisson_tpu_torch.utils import hashing

    d, w, n, chunk = P12["d"], P12["w"], P12["events"], P12["msg"]
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P12_DEVICE))
    try:
        cms = client.get_count_min_sketch("c5")
        check(cms.try_init(d, w, track_top_k=P12["top_k"]), "12a: try_init refused")
        bridge = TopicCmsBridge(client, "c5-events", "c5", batch_size=P12["batch_size"],
                                flush_interval_s=P12["flush_s"])
        topic = client.get_topic("c5-events")
        stream = (np.random.default_rng(3).zipf(1.2, size=n) % P12["keys"]).astype(np.uint64)
        topic.publish(stream[:chunk])  # one warm message first
        check(client._topic_bus.drain(timeout=300), "12a: warm delivery stuck")
        bridge.flush()
        seen = p12_dispatch_counter(client)
        timed = {}

        def window():
            t0 = time.perf_counter()
            for i in range(chunk, n, chunk):
                topic.publish(stream[i:i + chunk])
            check(client._topic_bus.drain(timeout=600), "12a: delivery stuck")
            bridge.close()
            timed["s"] = time.perf_counter() - t0

        if P12_DEVICE == "cuda":
            idle = device_idle_share(window, name="config5_pipe")
        else:  # a CPU rehearsal: no device to profile
            window()
            idle = {"wall_ms": None, "device_busy_ms": None, "idle_share": None}
        seen = dict(seen)  # the window's dispatches (top_k's reads come later)
        timed_events = n - chunk
        check(bridge.events_ingested == n, f"12a: bridge ingested {bridge.events_ingested}")
        check(cms.total_count() == n, f"12a: total_count {cms.total_count()} != {n}")
        g = golden.GoldenCountMinSketch(d, w)
        for i in range(0, n, 1 << 21):
            part = stream[i:i + (1 << 21)]
            g.add_hashed(*hashing.km_reduce_mod(
                *hashing.hash128_np(*hashing.encode_uint64_batch(part)), w))
        row = tenant_row(client, "c5")
        check(np.array_equal(row[:d * w].reshape(d, w), g.counts),
              "12a: CMS table differs from golden")
        true_top = set(np.argsort(-np.bincount(stream.astype(np.int64)))[:10].tolist())
        recall = len({int(k) for k, _ in cms.top_k(10)} & true_top) / 10.0
        check(recall == 1.0, f"12a: top-10 recall {recall}")
        check(seen["ops"] == timed_events, f"12a: dispatched {seen['ops']} of {timed_events}")
        check_healthy(client, "12a")
        out = {"phase": "12a", "config": f"config 5: RTopic -> TopicCmsBridge -> CMS({d}, {w})",
               "events": n, "timed_events": timed_events, "msg_events": chunk,
               "events_per_s": timed_events / timed["s"], "window_s": timed["s"],
               "cms_update_estimate_dispatches": seen["calls"],
               "events_per_dispatch": seen["ops"] / max(1, seen["calls"]),
               "table_equals_golden": True, "lost_events": 0, "top10_recall": recall,
               "device_wall_ms": idle["wall_ms"], "device_busy_ms": idle["device_busy_ms"],
               "device_idle_share": idle["idle_share"], "card": card}
        log(out)
        return out
    finally:
        client.shutdown()


def p12_server(device: str, reactor: bool = True):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.serve.resp import RespServer

    client = rt.create(rt.Config().use_gpu_sketch(device=device))
    client.config.resp_reactor = reactor
    return client, RespServer(client)


def p12_session(server, cmds) -> list:
    import socket

    s = socket.create_connection((server.host, server.port))
    try:
        out = []
        for c in cmds:
            s.sendall(wire([c]))
            out += read_frames(s, 1)
        return out
    finally:
        s.close()


def p12_serving_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate() if t.name.startswith("rtpu-resp"))


def phase_grid_wire(card: str) -> dict:
    """12b: the grid families over the wire on a card server (reactor on)
    against a ``device="cpu"`` port server in this process; pub/sub across
    two connections; a parked BLPOP while another connection pipelines."""
    import socket

    cc, cs = p12_server(P12_DEVICE)
    hc, hs = p12_server("cpu")
    out = {"phase": "12b"}
    try:
        check(cs.reactor is not None, "12b: the card server runs no reactor")
        cmds = [c for c, _ in P12_GRID]
        t0 = time.perf_counter()
        got = p12_session(cs, cmds)
        out["session_s"] = time.perf_counter() - t0
        ref = p12_session(hs, cmds)
        literal = 0
        for (cmd, want), a, b in zip(P12_GRID, got, ref):
            if isinstance(want, tuple):
                check(a.startswith(want[1]) and b.startswith(want[1]),
                      f"12b: {cmd}: {a!r} / {b!r}")
                if want[0] == "shape":
                    continue
            check(a == b, f"12b: {cmd}: card {a!r} != cpu {b!r}")
            if isinstance(want, bytes):
                check(a == want, f"12b: {cmd}: {a!r} != Redis's {want!r}")
                literal += 1
        out.update(commands=len(cmds), equal_to_cpu_server=True, literal_replies=literal)
        # pub/sub across two connections
        sub = socket.create_connection((cs.host, cs.port))
        pub = socket.create_connection((cs.host, cs.port))
        try:
            sub.sendall(wire([[b"SUBSCRIBE", b"p12-ch"]]))
            ack = read_frames(sub, 1)[0]
            check(ack == b"*3\r\n$9\r\nsubscribe\r\n$6\r\np12-ch\r\n:1\r\n", f"12b: ack {ack!r}")
            pub.sendall(wire([[b"PUBLISH", b"p12-ch", b"hello"], [b"PUBLISH", b"nobody", b"x"]]))
            counts = read_frames(pub, 2)
            check(counts == [b":1\r\n", b":0\r\n"], f"12b: PUBLISH counts {counts}")
            push = read_frames(sub, 1)[0]
            check(push == b"*3\r\n$7\r\nmessage\r\n$6\r\np12-ch\r\n$5\r\nhello\r\n",
                  f"12b: push {push!r}")
        finally:
            sub.close()
            pub.close()
        out["pubsub_frames_checked"] = True
        # a parked BLPOP while another connection pipelines
        n = P12["pipeline"]
        pre = [[b"BF.RESERVE", b"p12-bf", b"0.01", b"10000"],
               [b"BF.MADD", b"p12-bf"] + [b"k%d" % i for i in range(64)],
               [b"SET", b"p12-s", b"val"]]
        check(not any(f.startswith(b"-") for f in roundtrip(cs, pre)), "12b: setup failed")
        blocker = socket.create_connection((cs.host, cs.port))
        other = socket.create_connection((cs.host, cs.port))
        waker = socket.create_connection((cs.host, cs.port))
        try:
            base = p12_serving_threads()
            blocker.sendall(wire([[b"BLPOP", b"p12-q", b"0"]]))
            deadline = time.monotonic() + 30
            while not cc._grid.cond._waiters:
                check(time.monotonic() < deadline, "12b: BLPOP never parked")
                time.sleep(0.005)
            threads = p12_serving_threads()
            batch = [[b"BF.MEXISTS", b"p12-bf", b"k%d" % (i % 64), b"k%d" % ((i + 7) % 64)]
                     if i % 2 == 0 else [b"GET", b"p12-s"] for i in range(n)]
            t0 = time.perf_counter()
            other.sendall(wire(batch))
            frames = read_frames(other, n)
            pipe_s = time.perf_counter() - t0
            want = [b"*2\r\n:1\r\n:1\r\n" if i % 2 == 0 else b"$3\r\nval\r\n"
                    for i in range(n)]
            check(frames == want, "12b: pipelined replies wrong while BLPOP parked")
            check(p12_serving_threads() == threads,
                  f"12b: serving threads {threads} -> {p12_serving_threads()}")
            blocker.setblocking(False)
            try:
                early = blocker.recv(1 << 10)
            except BlockingIOError:
                early = b""
            blocker.setblocking(True)
            check(early == b"", f"12b: BLPOP answered early: {early!r}")
            waker.sendall(wire([[b"LPUSH", b"p12-q", b"wake"]]))
            check(read_frames(waker, 1) == [b":1\r\n"], "12b: LPUSH failed")
            popped = read_frames(blocker, 1)[0]
            check(popped == b"*2\r\n$5\r\np12-q\r\n$4\r\nwake\r\n", f"12b: BLPOP {popped!r}")
            deadline = time.monotonic() + 30  # the pop's worker exits
            while p12_serving_threads() != base:
                check(time.monotonic() < deadline,
                      f"12b: serving threads {base} -> {p12_serving_threads()}")
                time.sleep(0.01)
        finally:
            for s in (blocker, other, waker):
                s.close()
        out.update(blpop_parked_pipelined=n, pipelined_cmds_per_s=n / pipe_s,
                   serving_threads=len(base), serving_threads_while_parked=len(threads),
                   serving_threads_unchanged=True)
        check_healthy(cc, "12b")
        out["card"] = card
        log(out)
        return out
    finally:
        cs.close()
        cc.shutdown()
        hs.close()
        hc.shutdown()


C12C_WRITES = [
    [b"RPUSH", b"r-l", b"a", b"b", b"c"], [b"LPUSH", b"r-l", b"z"],
    [b"HSET", b"r-h", b"f1", b"v1", b"f2", b"v2"], [b"HINCRBY", b"r-h", b"n", b"7"],
    [b"ZADD", b"r-z", b"1.5", b"a", b"2", b"b", b"0.25", b"c"],
    [b"XADD", b"r-st", b"1-1", b"f", b"v1"], [b"XADD", b"r-st", b"2-0", b"f", b"v2"],
    [b"XGROUP", b"CREATE", b"r-st", b"g", b"0"],
    [b"XREADGROUP", b"GROUP", b"g", b"c1", b"COUNT", b"1", b"STREAMS", b"r-st", b">"],
    [b"GEOADD", b"r-g", b"13.361389", b"38.115556", b"Palermo",
     b"15.087269", b"37.502669", b"Catania"],
    [b"SADD", b"r-s", b"x", b"y"],
]
C12C_READS = [
    [b"LRANGE", b"r-l", b"0", b"-1"], [b"HGETALL", b"r-h"],
    [b"ZRANGE", b"r-z", b"0", b"-1", b"WITHSCORES"], [b"XRANGE", b"r-st", b"-", b"+"],
    [b"XPENDING", b"r-st", b"g"], [b"XINFO", b"STREAM", b"r-st"],
    [b"GEODIST", b"r-g", b"Palermo", b"Catania", b"km"], [b"GEOPOS", b"r-g", b"Palermo"],
    [b"SMEMBERS", b"r-s"], [b"TYPE", b"r-st"], [b"DBSIZE"],
]


def phase_grid_restart(card: str) -> dict:
    """12c: ``python -m redisson_tpu_torch`` with a snapshot directory: grid
    writes over the wire, SIGTERM, a reboot that answers every read equal."""
    import signal

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="phase12c-", dir=str(build))
    try:
        answers = []
        for boot in range(2):
            port = free_port()
            proc = c11d_boot(port, sdir)
            try:
                sock = c11d_connect(port, proc)
                if boot == 0:
                    sock.sendall(wire(C12C_WRITES))
                    w = read_frames(sock, len(C12C_WRITES))
                    check(not any(f.startswith(b"-") for f in w), f"12c: write failed: {w}")
                sock.sendall(wire(C12C_READS))
                answers.append(read_frames(sock, len(C12C_READS)))
                sock.close()
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=180)
                check(proc.returncode == 0, f"12c: exit {proc.returncode}: {out[-2000:]}")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=30)
        check(answers[0] == answers[1], f"12c: reboot answers differ: {answers}")
        check(answers[0][0] == b"*4\r\n$1\r\nz\r\n$1\r\na\r\n$1\r\nb\r\n$1\r\nc\r\n"
              and answers[0][6] == b"$8\r\n166.2742\r\n", f"12c: wrong answers {answers[0]}")
        out = {"phase": "12c", "entry_point": "python -m redisson_tpu_torch",
               "writes": len(C12C_WRITES), "reads": len(C12C_READS),
               "reads_equal_after_restart": True, "card": card}
        log(out)
        return out
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def phase_grid(card: str) -> None:
    phase_config5_pipe(card)
    phase_grid_wire(card)
    phase_grid_restart(card)


# -- phase 13: the coordination and services half ------------------------------

P13 = {"keys": 1 << 20, "add_chunk": 1 << 18, "contains": 1 << 20, "fpp": 0.01,
       "capacity": 1_048_576, "cms_tasks": 4, "cms_events": 524_288, "d": 5,
       "w": 1 << 16, "lock_threads": 8, "lock_rounds": 500, "sem_threads": 8,
       "sem_keys": 1 << 16, "lcm_entries": 100_000, "pings": 100,
       "monitor_s": 1.0, "prof_keys": 262_144}
P13_DEVICE = "cuda"
# Phase 2's rates, printed beside phase 13a's.
RATES: dict = {}


def p13_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P13_DEVICE, **kw))


def pctl_us(samples) -> dict:
    s = np.asarray(samples, np.float64) * 1e6
    return {"p50_us": float(np.percentile(s, 50)), "p99_us": float(np.percentile(s, 99))}


def bloom_seq_flags(idx: np.ndarray, m: int) -> np.ndarray:
    """GoldenBloomFilter.add_hashed's per-key flags from an empty filter,
    vectorized: a key is new exactly when it is the first key to set one
    of its bits."""
    n = idx.shape[0]
    first = np.full(m, n, np.int64)
    np.minimum.at(first, idx.reshape(-1).astype(np.int64),
                  np.repeat(np.arange(n, dtype=np.int64), idx.shape[1]))
    return np.any(first[idx.astype(np.int64)] == np.arange(n)[:, None], axis=1)


def cms_seq_unit(h1w, h2w, d: int, w: int):
    """cms_seq.golden_seq for unit weights from an empty table, vectorized:
    an event's estimate is the least, over its d cells, of the events so
    far (itself included) that hit the cell."""
    n = len(h1w)
    idx = np.asarray(h1w, np.int64).copy()
    step = np.asarray(h2w, np.int64)
    est = np.full(n, np.iinfo(np.int64).max)
    table = np.zeros((d, w), np.uint32)
    pos = np.arange(n)
    for r in range(d):
        if r:
            idx += step
            idx[idx >= w] -= w
        order = np.argsort(idx, kind="stable")
        s = idx[order]
        start = np.maximum.accumulate(np.where(np.r_[True, s[1:] != s[:-1]], pos, 0))
        seen = np.empty(n, np.int64)
        seen[order] = pos - start + 1
        est = np.minimum(est, seen)
        table[r] = np.bincount(idx, minlength=w)
    return table, est.astype(np.uint32)


def p13a_reactive_bloom(card: str) -> dict:
    """13a: config 1 through the reactive facade, against a sync client's
    run of the same keys and the golden model."""
    import asyncio

    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    n, chunk = P13["keys"], P13["add_chunk"]
    chunks = [np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64) for i in range(n // chunk)]
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, 2 * n, P13["contains"]).astype(np.uint64) for _ in range(4)]
    client, sync = p13_client(), p13_client()
    try:
        rc = client.reactive()
        warm = client.get_bloom_filter("p13-warm")  # first launches, untimed
        check(warm.try_init(P13["capacity"], P13["fpp"]), "try_init refused")
        warm.add_all_async(chunks[0]).result()
        warm.contains_each(batches[0])

        async def run():
            bf = rc.get_bloom_filter("p13-cfg1")
            check(await bf.try_init(P13["capacity"], P13["fpp"]), "reactive try_init refused")
            t0 = time.perf_counter()
            added = await asyncio.gather(*[bf.add_all_async(c) for c in chunks])
            add_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            hits = await asyncio.gather(*[bf.contains_each(b) for b in batches])
            return added, add_s, hits, time.perf_counter() - t0

        added, add_s, hits, contains_s = asyncio.run(run())
        sbf = sync.get_bloom_filter("p13-cfg1")
        check(sbf.try_init(P13["capacity"], P13["fpp"]), "sync try_init refused")
        s_added = [np.asarray(sbf.add_all_async(c).result()) for c in chunks]
        s_hits = [np.asarray(sbf.contains_each(b)) for b in batches]

        bf = client.get_bloom_filter("p13-cfg1")
        m, k = bf.get_size(), bf.get_hash_iterations()
        g = golden.GoldenBloomFilter(m, k)
        allk = np.concatenate(chunks)
        h1, h2 = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(allk)), m)
        idx = g._indexes(h1, h2)
        small = golden.GoldenBloomFilter(m, k)
        check(np.array_equal(bloom_seq_flags(idx[:4096], m), small.add_hashed(h1[:4096], h2[:4096])),
              "13a: the vectorized sequential flags differ from GoldenBloomFilter")
        # The sync run is one stream in chunk order: its flags are the
        # sequential golden model's, exactly.
        check(np.array_equal(np.concatenate(s_added), bloom_seq_flags(idx, m)),
              "13a: the sync client's add flags differ from the golden model")
        # The 4 reactive awaits run concurrently, so a flag depends on how
        # the other awaits' keys interleaved: it must lie between the
        # bounds of phase 11a (1 only if the key's bits were not all set by
        # earlier keys of its own await; 0 only if other keys set every
        # one of its bits).
        hitc = np.bincount(idx.reshape(-1).astype(np.int64), minlength=m)
        own = np.zeros(idx.shape, np.int64)
        for j in range(k):
            own[:, j] = (idx == idx[:, j:j + 1]).sum(axis=1)
        covered = np.all(hitc[idx.astype(np.int64)] - own > 0, axis=1)
        for i, a in enumerate(added):
            a = np.asarray(a)
            sl = slice(i * chunk, (i + 1) * chunk)
            check(a.shape == (chunk,), "13a: add flags malformed")
            check(np.all(a <= bloom_seq_flags(idx[sl], m)),
                  "13a: a key reported new whose bits its own await had set")
            check(np.all(a >= ~covered[sl]), "13a: a key reported present that no other key covers")
        n_added = int(sum(np.sum(a) for a in added))
        check(0.97 * n <= n_added <= n, f"13a: added {n_added} of {n}")
        g.bits[idx.reshape(-1)] = True
        row, srow = tenant_row(client, "p13-cfg1"), tenant_row(sync, "p13-cfg1")
        gbits = np.zeros(row.shape[0] * 32, bool)
        gbits[:m] = g.bits
        check(np.array_equal(row, np.packbits(gbits, bitorder="little").view(np.uint32))
              and np.array_equal(row, srow), "13a: the row differs from the golden bitmap")
        for b, h, sh in zip(batches, hits, s_hits):
            check(np.array_equal(np.asarray(h), sh) and np.array_equal(sh, golden_contains(g, b)),
                  "13a: contains differs from the sync client or the golden model")
        fpp = float(np.mean([np.asarray(h)[b >= n].mean() for b, h in zip(batches, hits)]))
        s_fpp = float(np.mean([h[b >= n].mean() for b, h in zip(batches, s_hits)]))
        check(fpp == s_fpp, "13a: the FPP differs from the sync client's")
        check_healthy(client, "13a")
        check_healthy(sync, "13a")
        out = {"phase": "13a", "config": "bloom 1M keys 1% FPP through reactive()",
               "add_ops_per_s": n / add_s, "contains_ops_per_s": 4 * P13["contains"] / contains_s,
               "phase2_add_ops_per_s": RATES.get("add_ops_per_s"),
               "phase2_contains_ops_per_s": RATES.get("contains_ops_per_s"),
               "added": n_added, "fpp_outside_keys": fpp, "row_equals_golden_and_sync": True,
               "card": card}
        log(out)
        return out
    finally:
        client.shutdown()
        sync.shutdown()


def p13b_executor_k1(client, rng, card: str) -> dict:
    """13b: an executor service whose tasks drive K1 (add_all_seq)."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    d, w, n, tasks = P13["d"], P13["w"], P13["cms_events"], P13["cms_tasks"]
    ex = client.get_executor_service("p13")
    ex.register_workers(tasks)
    streams = [zipf_keys(rng, n) for _ in range(tasks)]

    def task(i):
        cms = client.get_count_min_sketch(f"p13-cms-{i}")
        check(cms.try_init(d, w), "try_init refused")
        return np.asarray(cms.add_all_seq(streams[i]))

    before = cms_seq.LAUNCHES
    t0 = time.perf_counter()
    futs = [ex.submit(task, i) for i in range(tasks)]
    ests = [f.result(600) for f in futs]
    dt = time.perf_counter() - t0
    launches = cms_seq.LAUNCHES - before
    ex.shutdown()
    chunk = client._engine._SEQ_CHUNK
    check(launches == tasks * -(-n // chunk), f"13b: {launches} K1 launches")
    for i, est in enumerate(ests):
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(streams[i])), w)
        if i == 0:  # the vectorized twin against golden_seq itself
            t_ref, e_ref = cms_seq.golden_seq(np.zeros((d, w), np.uint32), h1w[:8192],
                                              h2w[:8192], np.ones(8192, np.uint32), d=d, w=w)
            t_vec, e_vec = cms_seq_unit(h1w[:8192], h2w[:8192], d, w)
            check(np.array_equal(t_ref, t_vec) and np.array_equal(e_ref, e_vec),
                  "13b: the vectorized golden_seq differs from golden_seq")
        table, want = cms_seq_unit(h1w, h2w, d, w)
        check(np.array_equal(est, want), f"13b: task {i}'s estimates differ from golden_seq")
        row = tenant_row(client, f"p13-cms-{i}")
        check(np.array_equal(row[: d * w].reshape(d, w), table),
              f"13b: task {i}'s table differs from golden_seq")
    out = {"phase": "13b", "config": "executor service, 4 tasks of CMS(5, 65536) add_all_seq",
           "events": tasks * n, "events_per_s": tasks * n / dt, "k1_launches": launches,
           "estimates_and_tables_equal_golden_seq": True, "card": card}
    log(out)
    return out


def p13c_locks(client, card: str) -> dict:
    """13c: a lock around card state, a semaphore around HLL adds, and a
    transaction over a map and a bucket."""
    from redisson_tpu_torch.grid import TransactionException
    from redisson_tpu_torch.ops import golden

    threads, rounds = P13["lock_threads"], P13["lock_rounds"]
    bs = client.get_bit_set("p13-bs")
    holds, errors = [], []

    def locked_rounds():
        lk = client.get_lock("p13-lk")
        mine = []
        try:
            for _ in range(rounds):
                lk.lock()
                t0 = time.perf_counter()
                try:
                    bs.set(bs.cardinality())
                finally:
                    mine.append(time.perf_counter() - t0)
                    lk.unlock()
        except Exception as e:  # surfaced below
            errors.append(e)
        holds.extend(mine)

    ts = [threading.Thread(target=locked_rounds) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    lock_s = time.perf_counter() - t0
    check(not errors, f"13c: lock rounds failed: {errors[:1]}")
    total = threads * rounds
    got = np.asarray(bs.get_many(np.arange(total + 64)))
    check(got[:total].all() and not got[total:].any() and bs.cardinality() == total
          and bs.length() == total, "13c: the set bits are not exactly 0..%d" % (total - 1))

    sem = client.get_semaphore("p13-sem")
    check(sem.try_set_permits(2), "13c: try_set_permits refused")
    hll = client.get_hyper_log_log("p13-hll")
    state = {"holders": 0, "peak": 0}
    guard = threading.Lock()
    keys = [np.arange(i * P13["sem_keys"], (i + 1) * P13["sem_keys"], dtype=np.uint64)
            for i in range(P13["sem_threads"])]

    def permitted(i):
        try:
            sem.acquire()
            try:
                with guard:
                    state["holders"] += 1
                    state["peak"] = max(state["peak"], state["holders"])
                hll.add_all(keys[i])
                with guard:
                    state["holders"] -= 1
            finally:
                sem.release()
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=permitted, args=(i,)) for i in range(P13["sem_threads"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errors, f"13c: semaphore rounds failed: {errors[:1]}")
    check(1 <= state["peak"] <= 2, f"13c: {state['peak']} semaphore holders at once")
    check(sem.available_permits() == 2, "13c: permits leaked")
    g = golden.GoldenHyperLogLog()
    for kk in keys:
        g.add_hashed(*hll_lanes(kk))
    check(np.array_equal(tenant_row(client, "p13-hll"), g.regs),
          "13c: HLL registers differ from the golden model")

    tx = client.create_transaction()
    tx.get_map("p13-m").put(1, 1)
    tx.get_bucket("p13-b").set(7)
    check(client.get_bucket("p13-b").get() is None, "13c: a write was visible before commit")
    tx.commit()
    check(client.get_map("p13-m").get(1) == 1 and client.get_bucket("p13-b").get() == 7,
          "13c: the commit did not apply")
    tx2 = client.create_transaction()
    tx2.get_bucket("p13-b").get()
    client.get_bucket("p13-b").set(8)
    tx2.get_bucket("p13-b").set(9)
    tx2.get_map("p13-m").put(1, 2)
    try:
        tx2.commit()
        fail("13c: a conflicting transaction committed")
    except TransactionException:
        pass
    check(client.get_bucket("p13-b").get() == 8 and client.get_map("p13-m").get(1) == 1,
          "13c: the conflicting transaction applied a write")
    out = {"phase": "13c", "config": "8 threads x 500 lock rounds around a BitSet on the card",
           "rounds": total, "rounds_per_s": total / lock_s,
           "lock_hold": pctl_us(holds), "semaphore_peak_holders": state["peak"],
           "bits_exact": True, "transaction_conflict_raised": True, "card": card}
    log(out)
    return out


def p13d_local_cached_map(client, card: str) -> dict:
    """13d: a LocalCachedMap of 100,000 entries read twice."""
    n = P13["lcm_entries"]
    m = client.get_local_cached_map("p13-lcm", cache_size=1 << 17, cache_max_bytes=256 << 20)
    m.put_all({i: i * 3 for i in range(n)})
    client._topic_bus.drain(timeout=60)
    got = [m.get(i) for i in range(n)]
    check(got == [i * 3 for i in range(n)], "13d: first pass read wrong values")
    h0 = m.cache_stats()["hits"]
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        v = m.get(i)
        lat.append(time.perf_counter() - t0)
        check(v == i * 3, "13d: second pass read a wrong value")
    hit_rate = (m.cache_stats()["hits"] - h0) / n
    other = client.get_local_cached_map("p13-lcm", cache_size=1 << 17, cache_max_bytes=256 << 20)
    m.put(n, 1)
    client._topic_bus.drain(timeout=10)
    check(other.get(n) == 1, "13d: a second handle missed a put through the first")
    other.put(n, 2)
    client._topic_bus.drain(timeout=10)
    check(m.get(n) == 2 and other.get(7) == 21, "13d: the handles disagree")
    out = {"phase": "13d", "config": "LocalCachedMap 100,000 entries, two read passes",
           "second_pass_hit_rate": hit_rate, "get": pctl_us(lat), "card": card}
    log(out)
    return out


def p13e_nodes(client, card: str) -> dict:
    """13e: the node is the card; pings and a failure monitor."""
    ng = client.get_nodes_group()
    nodes = ng.get_nodes()
    check(len(nodes) == 1, f"13e: {len(nodes)} nodes")
    kind = torch.cuda.get_device_name(0) if P13_DEVICE == "cuda" else "cpu"
    info = nodes[0].info()
    check(info["device_kind"] == kind, f"13e: device_kind {info['device_kind']!r}")
    check(ng.ping_all(), "13e: ping_all failed")
    lat = []
    for _ in range(P13["pings"]):
        t0 = time.perf_counter()
        check(nodes[0].ping(), "13e: a ping failed")
        lat.append(time.perf_counter() - t0)
    mon = client.get_failure_monitor(interval_s=0.1)
    events = []
    mon.add_listener(events.append)
    mon.start()
    time.sleep(P13["monitor_s"])
    mon.stop()
    check(not events and not mon.down_shards(), f"13e: the monitor saw {events}")
    out = {"phase": "13e", "node": info, "ping": pctl_us(lat), "monitor_events": 0, "card": card}
    log(out)
    return out


def p13f_profiler_metrics(client, card: str) -> dict:
    """13f: a profiler trace of a Bloom pass, device memory, the metrics'
    op count and the scrape endpoint."""
    import urllib.request

    n = P13["prof_keys"]
    bf = client.get_bloom_filter("p13-prof")
    check(bf.try_init(P13["capacity"], P13["fpp"]), "try_init refused")
    bf.add_all_async(np.arange(1024, dtype=np.uint64)).result()  # first launches
    ops0 = client.get_metrics()["ops_total"]
    prof = client.get_profiler()
    tmp = tempfile.mkdtemp(prefix="p13-trace-")
    try:
        with prof.trace(tmp):
            with prof.annotate("p13f-bloom-pass"):
                bf.add_all_async(np.arange(1024, 1024 + n, dtype=np.uint64)).result()
        with open(prof.last_trace) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(prof.last_trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if P13_DEVICE == "cuda":
        check(kernels, "13f: the trace holds no CUDA kernel event")
    ops = client.get_metrics()["ops_total"] - ops0
    check(ops == n, f"13f: ops_total grew by {ops}, the pass submitted {n}")
    mem = prof.device_memory()
    if P13_DEVICE == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        check(mem["gpu:0"]["bytes_limit"] == total,
              f"13f: device_memory {mem['gpu:0']} vs total_memory {total}")
    srv = client.start_metrics_endpoint("127.0.0.1", 0)
    body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
    fams = [ln.split()[2] for ln in client.obs.registry.render_prometheus().splitlines()
            if ln.startswith("# TYPE ")]
    check(fams and all(f"# TYPE {f} " in body for f in fams)
          and "redisson_tpu_ops_total" in body, "13f: the endpoint misses a family")
    out = {"phase": "13f", "trace_events": len(events), "trace_kernel_events": len(kernels),
           "trace_bytes": trace_bytes, "ops_total_delta": ops, "device_memory": mem,
           "endpoint_families": len(fams), "card": card}
    log(out)
    return out


def phase_services(rng, card: str) -> None:
    """Phase 13: the coordination and services half on fresh card clients."""
    p13a_reactive_bloom(card)
    client = p13_client()
    try:
        p13b_executor_k1(client, rng, card)
        check_healthy(client, "13b")
        p13c_locks(client, card)
        check_healthy(client, "13c")
        p13d_local_cached_map(client, card)
        p13e_nodes(client, card)
        p13f_profiler_metrics(client, card)
        check_healthy(client, "13")
    finally:
        client.shutdown()


# -- phase 14: the op journal, crash recovery and replication ----------------

P14 = {"keys": 1 << 20, "chunk": 1024, "threads": 4, "capacity": 1_048_576,
       "fpp": 0.01, "cms_events": 1 << 20, "d": 5, "w": 1 << 16,
       "hll_keys": 1 << 21, "bs_bits": 1 << 30, "bs_idx": 1 << 21,
       "big_chunk": 1 << 18, "k1_after": 1 << 18, "soak_seeds": (0, 1, 2),
       "soak_ops": 300, "repl_keys": 1 << 20, "repl_conns": 4, "repl_madd": 1024,
       "wait_every": 64, "e_batches": 40, "e_batch": 50, "e_kill_after": 20}
P14_DEVICE = "cuda"


def p14_sync() -> None:
    if P14_DEVICE == "cuda":
        torch.cuda.synchronize()


def p14_client(base=None, fsync="always", journal=True, snap=True, **kw):
    """A fresh client on the card with LongCodec; ``base`` holds its
    journal/ and snap/ directories."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P14_DEVICE, **kw)
    if base is not None and journal:
        cfg.journal_dir = os.path.join(base, "journal")
        cfg.journal_fsync = fsync
    if base is not None and snap:
        cfg.snapshot_dir = os.path.join(base, "snap")
    return rt.create(cfg)


def p14_abandon(client) -> None:
    """Shut a client down without its final snapshot and with the journal
    closed first (the next boot on the directory recovers its tail)."""
    eng = client._engine
    j, eng.journal = eng.journal, None
    if j is not None:
        j.close()
    eng.config.snapshot_dir = client.config.snapshot_dir = None
    client.shutdown()


def p14_streams(seed: int) -> dict:
    """The phase's inputs, a pure function of the seed (the crash child
    and the parent regenerate the same arrays)."""
    rng = np.random.default_rng(seed + 14)
    return {
        "bloom": rng.integers(0, 1 << 62, P14["keys"], dtype=np.uint64),
        "cms": zipf_keys(rng, P14["cms_events"]),
        "hll": rng.integers(0, 1 << 62, P14["hll_keys"], dtype=np.uint64),
        "bs": rng.integers(0, P14["bs_bits"], P14["bs_idx"], dtype=np.uint64).astype(np.uint32),
    }


def p14_bloom_load(client, name: str, keys: np.ndarray, ack=None) -> float:
    """Config 1: try_init(capacity, fpp), then the keys as add_all calls of
    ``chunk`` keys from ``threads`` threads; the wall seconds."""
    bf = client.get_bloom_filter(name)
    check(bf.try_init(P14["capacity"], P14["fpp"]), "try_init refused")
    chunk, nthreads = P14["chunk"], P14["threads"]
    n = len(keys) // chunk
    errors = []

    def worker(t):
        try:
            for i in range(t, n, nthreads):
                bf.add_all(keys[i * chunk:(i + 1) * chunk])
                if ack is not None:
                    ack("bloom", i)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(nthreads)]
    p14_sync()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    check(not errors, f"bloom load failed: {errors[:1]}")
    return dt


def p14_bloom_words(client, name: str, keys: np.ndarray) -> np.ndarray:
    """The golden bitmap of ``keys`` in ``name``'s row layout."""
    bf = client.get_bloom_filter(name)
    g = golden_bloom(bf, keys)
    units = client._engine.registry.lookup(name).pool.row_units
    gbits = np.zeros(units * 32, bool)
    gbits[: g.size] = g.bits
    return np.packbits(gbits, bitorder="little").view(np.uint32)


def p14_golden_hll(keys: np.ndarray) -> np.ndarray:
    from redisson_tpu_torch.ops import golden

    idx, rank = golden.hll_index_rank(*hll_lanes(keys))
    regs = np.zeros(golden.HLL_M, np.uint8)
    np.maximum.at(regs, np.asarray(idx, np.int64), np.asarray(rank, np.uint8))
    return regs


def p14_golden_bits(idx: np.ndarray, nbits: int) -> np.ndarray:
    words = np.zeros(nbits // 32, np.uint32)
    np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
    return words


def p14_golden_cms(events: np.ndarray):
    from redisson_tpu_torch.utils import hashing

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(events)), P14["w"])
    return h1w, h2w


def p14_df(path: str) -> str:
    out = subprocess.run(["df", "-T", path], capture_output=True, text=True, timeout=60)
    return " ".join(out.stdout.strip().splitlines()[-1].split())


def p14_fsync_pctl(obs) -> dict:
    p50, p99 = obs.journal_fsync_us.percentiles((), [50, 99])
    return {"fsync_p50_us": p50 * 1e6, "fsync_p99_us": p99 * 1e6}


def p14a_appendfsync(streams, base: str, card: str) -> None:
    """14a: the cost of appendfsync on the main path — config 1's load in
    four arms on one client (journal off, no, everysec, always), each on
    a fresh filter; then config 5's K1 stream under always."""
    from redisson_tpu_torch.ops import cms_seq

    client = p14_client(base, fsync="everysec", snap=False)
    eng, obs = client._engine, client._engine.obs
    keys = streams["bloom"]
    want = None
    arms = {}
    try:
        # Warm-up on a filter of the same size class, so no arm pays the
        # process's first launches.
        eng.journal_set_enabled(False)
        p14_bloom_load(client, "p14a-warm", keys[: 64 * P14["chunk"]])
        for arm in ("off", "no", "everysec", "always"):
            if arm == "off":
                eng.journal_set_enabled(False)
            else:
                eng.journal_set_enabled(True)
                eng.journal_set_policy(arm)
            check((eng.journal is None) == (arm == "off"), f"14a: journal state in arm {arm}")
            obs.journal_fsync_us.reset()
            st0 = eng.journal.stats() if eng.journal is not None else None
            dt = p14_bloom_load(client, f"p14a-{arm}", keys)
            out = {"keys_per_s": len(keys) / dt, "seconds": dt}
            if st0 is not None:
                check(eng.journal_fence(timeout=60), "14a: fence timed out")
                st = eng.journal.stats()
                recs = st["records_written"] - st0["records_written"]
                fs = st["fsyncs"] - st0["fsyncs"]
                out.update(records=recs, journal_bytes_per_key=(
                    st["bytes_written"] - st0["bytes_written"]) / len(keys),
                    fsyncs=fs, records_per_fsync=recs / max(1, fs),
                    **p14_fsync_pctl(obs))
                check(recs == len(keys) // P14["chunk"] + 1, f"14a: {recs} records in arm {arm}")
            if want is None:
                want = p14_bloom_words(client, f"p14a-{arm}", keys)
            check(np.array_equal(tenant_row(client, f"p14a-{arm}"), want),
                  f"14a: arm {arm}'s row differs from the golden bitmap")
            arms[arm] = out
        # Config 5 under always: K1 on the journaled path.
        d, w = P14["d"], P14["w"]
        cms = client.get_count_min_sketch("p14a-cms")
        check(cms.try_init(d, w), "try_init refused")
        events = streams["cms"]
        before = cms_seq.LAUNCHES
        p14_sync()
        t0 = time.perf_counter()
        est = cms.add_all_seq(events)
        dt = time.perf_counter() - t0
        launches = cms_seq.LAUNCHES - before
        check(launches == -(-len(events) // eng._SEQ_CHUNK), f"14a: {launches} K1 launches")
        h1w, h2w = p14_golden_cms(events)
        table, g_est = cms_seq_unit(h1w, h2w, d, w)
        check(np.array_equal(np.asarray(est, np.uint32), g_est), "14a: estimates != golden_seq")
        check(np.array_equal(tenant_row(client, "p14a-cms")[: d * w].reshape(d, w), table),
              "14a: CMS table != golden")
        check_healthy(client, "14a")
        log({"phase": "14a", "config": "config 1 bloom 1M / 1% from 4 threads; config 5 cms",
             "keys": len(keys), "calls_per_arm": len(keys) // P14["chunk"], "arms": arms,
             "always_vs_off_keys_per_s": arms["always"]["keys_per_s"] / arms["off"]["keys_per_s"],
             "cms_events": len(events), "cms_events_per_s_always": len(events) / dt,
             "cms_k1_launches": launches, "rows_equal_golden": True,
             "cms_equals_golden_seq": True, "filesystem": p14_df(base), "card": card})
    finally:
        p14_abandon(client)


def p14_child(base: str, seed: int) -> int:
    """14b's crash child: the always Bloom arm, a snapshot, then the CMS
    stream (K1), an HLL PFADD and a 2**30-bit BitSet's set_many, journaled
    under always; one ``ACK`` line per resolved call, the live rows saved,
    ``LAST``, and then it waits for its SIGKILL."""
    streams = p14_streams(seed)
    lock = threading.Lock()

    def ack(kind, i):
        with lock:
            sys.stdout.write(f"ACK {kind} {i}\n")
            sys.stdout.flush()

    client = p14_client(base, fsync="always")
    eng = client._engine
    times = {"bloom_s": p14_bloom_load(client, "p14b-bloom", streams["bloom"], ack)}
    segs = eng.journal.stats()["segments"]
    t0 = time.perf_counter()
    eng.snapshot(client.config.snapshot_dir)
    times["snapshot_s"] = time.perf_counter() - t0
    retired = segs + 1 - eng.journal.stats()["segments"]  # mark_snapshot rotates one in
    cms = client.get_count_min_sketch("p14b-cms")
    cms.try_init(P14["d"], P14["w"])
    big = P14["big_chunk"]
    t0 = time.perf_counter()
    for i in range(0, len(streams["cms"]), big):
        cms.add_all_seq(streams["cms"][i:i + big])
        ack("cms", i // big)
    times["cms_s"] = time.perf_counter() - t0
    hll = client.get_hyper_log_log("p14b-hll")
    t0 = time.perf_counter()
    for i in range(0, len(streams["hll"]), big):
        hll.add_all(streams["hll"][i:i + big])
        ack("hll", i // big)
    times["hll_s"] = time.perf_counter() - t0
    bs = client.get_bit_set("p14b-bs")
    bs.set(P14["bs_bits"] - 1, False)  # size the row to 2**30 bits
    t0 = time.perf_counter()
    for i in range(0, len(streams["bs"]), big):
        bs.set_many(streams["bs"][i:i + big], True)
        ack("bs", i // big)
    times["bs_s"] = time.perf_counter() - t0
    eng._drain()
    np.savez(os.path.join(base, "live_rows.npz"), **{
        n: np.asarray(eng.executor.read_row(e.pool, e.row))
        for n, e in ((e.name, e) for e in eng.registry.entries())})
    print(json.dumps({"child": "14b", "segments_retired_by_snapshot": retired,
                      "journal": eng.journal.stats(), **times}), flush=True)
    print("LAST", flush=True)
    time.sleep(3600)  # the parent's SIGKILL lands here, before any shutdown
    return 0


def p14b_kill9(streams, base: str, seed: int, card: str) -> None:
    """14b: SIGKILL a child after its last ack, boot a fresh card client
    on its directories and hold every recovered row to the acked golden
    state; then K1 on the recovered CMS row."""
    import signal

    from redisson_tpu_torch.ops import cms_seq

    cfg = json.dumps({"P14": P14, "device": P14_DEVICE})
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--p14-child",
                             base, "--seed", str(seed), "--p14-config", cfg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    acks, child = 0, None
    try:
        for line in proc.stdout:
            if line.startswith("ACK "):
                acks += 1
            elif line.startswith("{"):
                child = json.loads(line)
            elif line.strip() == "LAST":
                break
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    check(child is not None, f"14b: the child never finished its stream:\n{err[-4000:]}")
    big = P14["big_chunk"]
    want_acks = (len(streams["bloom"]) // P14["chunk"]
                 + sum(-(-len(streams[k]) // big) for k in ("cms", "hll", "bs")))
    check(acks == want_acks, f"14b: {acks} acks, expected {want_acks}")
    live = dict(np.load(os.path.join(base, "live_rows.npz")))
    p14_sync()
    t0 = time.perf_counter()
    client = p14_client(base, fsync="always")
    p14_sync()
    boot_s = time.perf_counter() - t0
    try:
        eng = client._engine
        rs = eng.recovery_stats or {}
        check(all(p.state.device.type == P14_DEVICE for p in eng.registry.pools()),
              "14b: a recovered pool is not on the card")
        d, w = P14["d"], P14["w"]
        h1w, h2w = p14_golden_cms(streams["cms"])
        gcms, _ = cms_seq_unit(h1w, h2w, d, w)
        golden_rows = {
            "p14b-bloom": p14_bloom_words(client, "p14b-bloom", streams["bloom"]),
            "p14b-hll": p14_golden_hll(streams["hll"]),
            "p14b-bs": p14_golden_bits(np.r_[streams["bs"]], P14["bs_bits"]),
        }
        rows = {e.name: np.asarray(eng.executor.read_row(e.pool, e.row))
                for e in eng.registry.entries()}
        check(set(rows) == set(live) == {"p14b-bloom", "p14b-cms", "p14b-hll", "p14b-bs"},
              f"14b: recovered names {sorted(rows)}")
        for n, g in golden_rows.items():
            check(np.array_equal(rows[n], g), f"14b: recovered {n} != golden")
            check(np.array_equal(live[n], g), f"14b: live {n} != golden")
        check(np.array_equal(rows["p14b-cms"][: d * w].reshape(d, w), gcms),
              "14b: recovered CMS table != golden")
        check(np.array_equal(live["p14b-cms"], rows["p14b-cms"]),
              "14b: the table K1 wrote live != the table recovery rebuilt")
        # K1 on the recovered row.
        more = zipf_keys(np.random.default_rng(seed + 141), P14["k1_after"])
        m1, m2 = p14_golden_cms(more)
        g_table, g_est = cms_seq.golden_seq(gcms, m1, m2, np.ones(len(more), np.uint32),
                                            d=d, w=w)
        before = cms_seq.LAUNCHES
        est = client.get_count_min_sketch("p14b-cms").add_all_seq(more)
        k1 = cms_seq.LAUNCHES - before
        check(k1 > 0, "14b: K1 did not launch on the recovered row")
        check(np.array_equal(np.asarray(est, np.uint32), g_est), "14b: K1 estimates != golden_seq")
        check(np.array_equal(tenant_row(client, "p14b-cms")[: d * w].reshape(d, w), g_table),
              "14b: K1 table on the recovered row != golden_seq")
        check_healthy(client, "14b")
        log({"phase": "14b", "acked_calls": acks, "child": child, "boot_s": boot_s,
             "recovery_s": rs.get("seconds"), "records_replayed": rs.get("records"),
             "replayed_records_per_s": rs.get("records", 0) / max(1e-9, rs.get("seconds", 0)),
             "rows_written": rs.get("rows_written"),
             "segments_retired_by_snapshot": child["segments_retired_by_snapshot"],
             "rows_equal_acked_golden": True, "live_k1_table_equals_recovered": True,
             "k1_on_recovered_row_launches": k1, "card": card})
    finally:
        p14_abandon(client)


def p14c_soak(base: str, card: str) -> None:
    """14c: the JAX package's kill -9 soak with the port's crash child on
    the card: seeds x {always, everysec}, one run with mid-stream
    snapshots and one with forced residency transitions, all children at
    once; each killed at an ack count drawn from random.Random(seed);
    recovery on the card; rows matched against a golden prefix."""
    import random
    import signal

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.chaos import crashchild
    from redisson_tpu_torch.codecs import LongCodec

    ops = P14["soak_ops"]
    runs = [(s, f, ()) for s in P14["soak_seeds"] for f in ("always", "everysec")]
    runs += [(3, "always", ("--snapshot-every", "50")),
             (4, "always", ("--residency-every", "25"))]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    procs = []
    for i, (seed, fsync, extra) in enumerate(runs):
        d = os.path.join(base, f"run{i}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "redisson_tpu_torch.chaos.crashchild", "--dir", d,
             "--fsync", fsync, "--seed", str(seed), "--ops", str(ops), "--device", P14_DEVICE,
             *extra], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
            cwd=str(Path(__file__).resolve().parent)))
    results = [None] * len(runs)

    def drive(i):
        seed, fsync, _ = runs[i]
        proc = procs[i]
        kill_at = random.Random(seed).randrange(40, ops - 20)
        acked = {}
        for line in proc.stdout:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
                if int(parts[1]) >= kill_at:
                    break
        kill_time = time.time()
        proc.send_signal(signal.SIGKILL)
        for line in proc.stdout:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
        proc.wait(timeout=60)
        results[i] = (acked, kill_time, kill_at)

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(len(runs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    children_s = time.perf_counter() - t0
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.stdout.close()
    out = []
    for i, (seed, fsync, extra) in enumerate(runs):
        check(results[i] is not None, f"14c: run {i} never finished")
        acked, kill_time, kill_at = results[i]
        check(acked and max(acked) >= kill_at, f"14c: run {i} stopped at {max(acked or [0])}")
        d = os.path.join(base, f"run{i}")
        client = crashchild.build_client(d, fsync, residency=bool(extra and "resid" in extra[0]),
                                         device=P14_DEVICE)
        eng = client._engine
        try:
            check(all(p.state.device.type == P14_DEVICE for p in eng.registry.pools()),
                  "14c: a recovered pool is not on the card")
            eng._drain()
            rows = {e.name: np.asarray(eng._host_row(e)).copy() for e in eng.registry.entries()}
            rs = eng.recovery_stats or {}
        finally:
            p14_abandon(client)
        if fsync == "always":
            lower = max(acked) + 1
        else:
            covered = [j for j, ts in acked.items() if ts <= kill_time - 2.5]
            lower = (max(covered) + 1) if covered else 0
        golden = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
            device="cpu", min_bucket=64))
        matched = [None]

        def same():
            golden._engine._drain()
            got = {e.name: np.asarray(golden._engine._host_row(e))
                   for e in golden._engine.registry.entries()}
            return set(got) == set(rows) and all(np.array_equal(got[n], rows[n]) for n in got)

        class _Hit(Exception):
            pass

        def on_ack(j):
            if j + 1 >= lower and same():
                matched[0] = j + 1
                raise _Hit()

        try:
            if lower <= 0 and same():
                matched[0] = 0
            else:
                crashchild.apply_ops(golden, seed, ops, ack=on_ack)
        except _Hit:
            pass
        finally:
            golden.shutdown()
        check(matched[0] is not None,
              f"14c: run {i} ({fsync} {extra}) matches no golden prefix >= {lower}")
        out.append({"seed": seed, "fsync": fsync, "extra": " ".join(extra),
                    "max_acked": max(acked), "golden_prefix": matched[0], "lower": lower,
                    "records_replayed": rs.get("records"), "recovery_s": rs.get("seconds")})
    log({"phase": "14c", "runs": out, "children_wall_s": children_s,
         "every_acked_write_recovered": True, "card": card})


def p14_cmds(server, cmds):
    from redisson_tpu_torch.serve.wireutil import exchange

    s = socket.create_connection((server.host, server.port), timeout=120)
    try:
        return exchange(s, cmds)
    finally:
        s.close()


def p14d_replication(streams, base: str, card: str) -> None:
    """14d: a primary and a replica RespServer, each on its own card
    client in this process: FULLRESYNC of config 1 and config 5, then 4
    connections of BF.MADD with WAIT 1 every 64 commands, a dropped link
    that resyncs partially, -READONLY, and FAILOVER."""
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

    pc = p14_client(os.path.join(base, "primary"), fsync="everysec")
    ps = RespServer(pc)
    rc = rs = None
    try:
        t_load = p14_bloom_load(pc, "p14d", streams["bloom"])
        cms = pc.get_count_min_sketch("p14d-cms")
        cms.try_init(P14["d"], P14["w"])
        cms.add_all_seq(streams["cms"])
        rc = p14_client(os.path.join(base, "replica"), journal=False)
        rs = RespServer(rc)
        t0 = time.perf_counter()
        link = rs.start_replication_from(ps.host, ps.port)
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head, "14d: replica bootstrap", timeout=600)
        fullresync_s = time.perf_counter() - t0
        check(link.full_resyncs == 1, "14d: expected one FULLRESYNC")
        # The live stream: BF.MADD from 4 connections, WAIT 1 every 64.
        extra = np.random.default_rng(1414).integers(0, 1 << 62, P14["repl_keys"],
                                                     dtype=np.uint64)
        conns, madd = P14["repl_conns"], P14["repl_madd"]
        per = len(extra) // conns
        waits, lag_max, errors = [], [0], []
        stop = threading.Event()

        def monitor():
            while not stop.is_set():
                lag_max[0] = max(lag_max[0], link.lag_ops())
                time.sleep(0.005)

        def sender(c):
            try:
                s = socket.create_connection((ps.host, ps.port), timeout=120)
                mine = extra[c * per:(c + 1) * per]
                cmds = [("BF.MADD", "p14d", *map(str, mine[i:i + madd].tolist()))
                        for i in range(0, len(mine), madd)]
                for i in range(0, len(cmds), P14["wait_every"]):
                    replies = exchange(s, cmds[i:i + P14["wait_every"]])
                    check(not any(isinstance(r, ReplyError) for r in replies), "14d: MADD error")
                    w0 = time.perf_counter()
                    (n,) = exchange(s, [("WAIT", "1", "1000")])
                    waits.append(time.perf_counter() - w0)
                    check(n == 1, f"14d: WAIT 1 answered {n}")
                s.close()
            except BaseException as e:
                errors.append(e)

        rec0 = link.applied
        mon = threading.Thread(target=monitor)
        mon.start()
        t0 = time.perf_counter()
        senders = [threading.Thread(target=sender, args=(c,)) for c in range(conns)]
        for t in senders:
            t.start()
        for t in senders:
            t.join()
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head, "14d: replica catch-up", timeout=600)
        stream_s = time.perf_counter() - t0
        stop.set()
        mon.join()
        check(not errors, f"14d: sender failed: {errors[:1]}")
        applied = link.applied - rec0
        prow = {n: tenant_row(pc, n) for n in ("p14d", "p14d-cms")}
        check(all(np.array_equal(tenant_row(rc, n), r) for n, r in prow.items()),
              "14d: replica rows != primary rows")
        all_keys = np.concatenate([streams["bloom"], extra])
        check(np.array_equal(prow["p14d"], p14_bloom_words(pc, "p14d", all_keys)),
              "14d: primary row != golden")
        # -READONLY on the replica.
        (r,) = p14_cmds(rs, [("BF.MADD", "p14d", "1")])
        check(isinstance(r, ReplyError) and r.code == "READONLY", f"14d: replica write got {r}")
        # A dropped link resyncs partially.
        hub = ps._repl_hub()
        fr0, pr0 = hub.fullresyncs, pc.obs.repl_partial_resyncs.get(())
        link._sock.close()
        p14_cmds(ps, [("BF.MADD", "p14d", "7", "8", "9")])
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head and link.link_up, "14d: partial resync", timeout=120)
        check(pc.obs.repl_partial_resyncs.get(()) == pr0 + 1 and hub.fullresyncs == fr0,
              "14d: the dropped link did not resync partially")
        # FAILOVER promotes the replica; every WAIT-covered write reads back.
        check(p14_cmds(rs, [("FAILOVER",)]) == [b"OK"], "14d: FAILOVER refused")
        check(rs.replica_link is None, "14d: still a replica after FAILOVER")
        check(p14_cmds(rs, [("BF.MADD", "p14d", "424242")]) == [[1]], "14d: promoted write")
        probe = all_keys[:: max(1, len(all_keys) // 65536)]
        got = rc.get_bloom_filter("p14d").contains_each(probe)
        check(bool(np.all(got)), "14d: a WAIT-covered write is missing on the promoted node")
        check_healthy(pc, "14d")
        check_healthy(rc, "14d")
        w_us = np.asarray(waits) * 1e6
        log({"phase": "14d", "primary_load_s": t_load, "fullresync_s": fullresync_s,
             "fullresync_tar_bytes": link.last_resync_bytes, "stream_keys": len(extra),
             "stream_s": stream_s, "replica_applied_records": applied,
             "replica_applied_records_per_s": applied / stream_s,
             "replica_max_lag_ops": lag_max[0], "waits": len(waits),
             "wait_p50_us": float(np.percentile(w_us, 50)),
             "wait_p99_us": float(np.percentile(w_us, 99)),
             "rows_equal": True, "readonly": True, "partial_resync": True,
             "failover": True, "card": card})
    finally:
        if rs is not None:
            rs.close()
        ps.close()
        for c in (rc, pc):
            if c is not None:
                p14_abandon(c)


def p14e_entry_point(base: str, card: str) -> None:
    """14e: ``python -m redisson_tpu_torch --journal-dir --snapshot-dir``
    under appendfsync always, SIGKILLed in the middle of a pipelined
    SET/BF.MADD stream, then rebooted: every acknowledged write reads
    back."""
    import signal

    from redisson_tpu_torch.serve.wireutil import exchange

    sdir, jdir = os.path.join(base, "snap"), os.path.join(base, "journal")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))

    def boot():
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port), "--device",
             P14_DEVICE, "--snapshot-dir", sdir, "--journal-dir", jdir],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, c11d_connect(port, proc)

    proc, sock = boot()
    acked_sets, acked_keys = [], []
    try:
        check(exchange(sock, [("CONFIG", "SET", "appendfsync", "always"),
                              ("BF.RESERVE", "p14e", "0.01", "100000")]) == [b"OK", b"OK"],
              "14e: setup")
        nb, bsz = P14["e_batches"], P14["e_batch"]
        for b in range(nb):
            cmds = []
            for j in range(bsz):
                k = b * bsz + j
                cmds.append(("SET", f"p14e-{k}", str(k * 7)) if j % 2 else
                            ("BF.MADD", "p14e", *(str(k * 1000 + x) for x in range(16))))
            sock.sendall(wire([[str(a).encode() for a in c] for c in cmds]))
            frames = read_frames(sock, len(cmds))
            for c, f in zip(cmds, frames):
                check(not f.startswith(b"-"), f"14e: {c[0]} failed: {f[:200]}")
                if c[0] == "SET":
                    acked_sets.append((c[1], c[2]))
                else:
                    acked_keys.extend(c[2:])
            if b == P14["e_kill_after"]:
                # Mid-stream: the next batch is on the wire, unanswered.
                sock.sendall(wire([[b"SET", b"p14e-inflight", b"x"]] * bsz))
                proc.send_signal(signal.SIGKILL)
                break
        proc.wait(timeout=60)
        check(proc.returncode == -signal.SIGKILL, f"14e: exit {proc.returncode}")
        sock.close()
        t0 = time.perf_counter()
        proc, sock = boot()
        reboot_s = time.perf_counter() - t0
        gets = exchange(sock, [("GET", k) for k, _ in acked_sets])
        check(gets == [v.encode() for _, v in acked_sets], "14e: an acked SET was lost")
        hits = exchange(sock, [("BF.MEXISTS", "p14e", *acked_keys)])[0]
        check(all(int(h) == 1 for h in hits), "14e: an acked BF.MADD key was lost")
        info = exchange(sock, [("INFO", "persistence")])[0].decode()
        check("aof_enabled:1" in info, "14e: the rebooted server has no journal")
        log({"phase": "14e", "acked_sets": len(acked_sets), "acked_bloom_keys": len(acked_keys),
             "reboot_s": reboot_s, "all_acked_writes_read_back": True,
             "aof": [ln for ln in info.split("\r\n") if ln.startswith("aof_replayed")],
             "card": card})
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate(timeout=30)
        sock.close()


def phase_durability(seed: int, card: str) -> None:
    """Phase 14: the op journal, kill -9 recovery and the replication
    stream on fresh card clients."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    base = tempfile.mkdtemp(prefix="phase14-", dir=str(build))
    try:
        t0 = time.perf_counter()
        streams = p14_streams(seed)
        p14a_appendfsync(streams, os.path.join(base, "a"), card)
        p14b_kill9(streams, os.path.join(base, "b"), seed, card)
        p14c_soak(os.path.join(base, "c"), card)
        p14d_replication(streams, os.path.join(base, "d"), card)
        p14e_entry_point(os.path.join(base, "e"), card)
        log({"phase": 14, "seconds": time.perf_counter() - t0, "card": card})
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-k1", metavar="SOURCE",
                    help="a K1 source with the one-warp-per-row interface, timed beside K1")
    ap.add_argument("--p10c-child", choices=("warm", "cold"), help=argparse.SUPPRESS)
    ap.add_argument("--p14-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--p14-config", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.p14_child:
        global P14_DEVICE
        cfg = json.loads(args.p14_config)
        P14.update(cfg["P14"])
        P14_DEVICE = cfg["device"]
        return p14_child(args.p14_child, args.seed)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.p10c_child:
        return p10c_child(args.p10c_child)

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
        check_healthy(client, 2)
        phase_tenants(client, rng)
        check_healthy(client, 3)
        phase_cms(client, rng, card)
        check_healthy(client, 4)
        kernel["launches"] = cms_seq.LAUNCHES
        by_phase = kernel["launches_by_phase"] = {"2-4": cms_seq.LAUNCHES}
        check(kernel["launches"] > 0, "the main path never launched K1")
        phase_hll(client, rng, card)
        check_healthy(client, 5)
        phase_bitset(client, rng, card)
        check_healthy(client, 6)
        cms_seq.LAUNCHES = 0  # phase 8's path, counted on its own
        phase_lifecycle(client, rng, g, args.seed, card)
        check_healthy(client, 8)
        check(cms_seq.LAUNCHES > 0, "phase 8 never launched K1")
        kernel["launches"] += cms_seq.LAUNCHES
        by_phase["8"] = cms_seq.LAUNCHES
    finally:
        client.shutdown()
    phase_interleaved(rng)
    cms_seq.LAUNCHES = 0  # phase 9's path, counted on its own
    phase_failover(rng, args.seed, card)
    check(cms_seq.LAUNCHES > 0, "phase 9 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["9"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 10's path, counted on its own
    phase_tiers(rng, card)
    check(cms_seq.LAUNCHES > 0, "phase 10 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["10"] = cms_seq.LAUNCHES
    phase_frontdoor(rng, args.seed, card)
    cms_seq.LAUNCHES = 0  # phase 12's path: the bridge takes cms_add, not K1
    phase_grid(card)
    by_phase["12"] = cms_seq.LAUNCHES
    check(by_phase["12"] == 0, "phase 12's bridge launched K1")
    cms_seq.LAUNCHES = 0  # phase 13's path: K1 through the executor service
    phase_services(rng, card)
    check(cms_seq.LAUNCHES > 0, "phase 13 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["13"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 14's path: K1 under the journal and on a recovered row
    phase_durability(args.seed, card)
    check(cms_seq.LAUNCHES > 0, "phase 14 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["14"] = cms_seq.LAUNCHES
    log({"kernels": [kernel]})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
