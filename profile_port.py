"""Where redisson_tpu_torch's time goes on one CUDA card.

Drives the main path through the client, warms each pass up once, then
runs it again under ``torch.profiler`` and prints one JSON line per pass:

  bloom_add       config 1: add_all_async, 4 x 262,144 keys into a
                  1M-key / 1% FPP filter (its own fresh filter)
  bloom_contains  config 1: contains_many over 4 x 1M random keys
  cms_add_seq     config 5: add_all_seq over 2M zipf(1.2) events into a
                  5 x 65536 sketch (62 launches of kernel K1)
  hll_pfadd       config 2: 4 x 2**21 keys into a fresh RHyperLogLog,
                  issued together and resolved with collect
  bitset_mixed    config 3: 8 alternating set_many_async / get_many_async
                  of 2**21 uniform indexes on a 2**30-bit RBitSet, resolved
                  with collect

Each line has the pass's wall time (host clock, ending in a device
synchronize), the device busy time (union of the CUDA kernel and memcpy
intervals the profiler recorded), the idle share (1 - busy / wall), and
the top device ops.  Chrome traces go to ``<trace-dir>/<pass>.json``.
If the profiler records no device activity, busy time and idle share are
reported as null.

    python3 profile_port.py [--seed N] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_pass(name: str, fn, out_dir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: the first CUDA launch of each op is not the steady state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_dev = defaultdict(float)
    for e in dev:
        by_dev[e.name[:80]] += e.time_range.elapsed_us()
    busy = _busy_us(dev) if dev else None
    return {
        "pass": name,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": None if busy is None else busy / 1e3,
        "idle_share": None if busy is None else 1.0 - busy / wall_us,
        "device_events": len(dev),
        "top_device_ms": {k: v / 1e3 for k, v in
                          sorted(by_dev.items(), key=lambda kv: -kv[1])[:8]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    out_dir = args.trace_dir
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch())
    try:
        n_load, chunk = 1 << 20, 1 << 18
        adds = iter(range(1 << 10))

        def bloom_add():
            bf = client.get_bloom_filter(f"add{next(adds)}")
            bf.try_init(1_000_000, 0.01)
            futs = [bf.add_all_async(np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64))
                    for i in range(n_load // chunk)]
            for f in futs:
                f.result()

        bf = client.get_bloom_filter("cfg1")
        bf.try_init(1_000_000, 0.01)
        bf.add_all(np.arange(n_load, dtype=np.uint64))
        batches = [rng.integers(0, 2 * n_load, 1 << 20).astype(np.uint64)
                   for _ in range(4)]
        cms = client.get_count_min_sketch("cms")
        cms.try_init(5, 1 << 16, track_top_k=20)
        events = (rng.zipf(1.2, 2_000_000) % 100_000).astype(np.uint64)

        B = 1 << 21
        hlls = iter(range(1 << 10))

        def hll_pfadd():
            h = client.get_hyper_log_log(f"hll{next(hlls)}")
            with client.defer_fetch():
                futs = [h.add_all_async(np.arange(i * B, (i + 1) * B, dtype=np.uint64))
                        for i in range(4)]
            client.collect(futs)

        nbits = 1 << 30
        bs = client.get_bit_set("cfg3")
        bs.set(nbits - 1)
        idxs = [rng.integers(0, nbits, B).astype(np.uint32) for _ in range(8)]

        def bitset_mixed():
            with client.defer_fetch():
                futs = [bs.set_many_async(idx) if i % 2 == 0 else bs.get_many_async(idx)
                        for i, idx in enumerate(idxs)]
            client.collect(futs)

        for name, fn in (
            ("bloom_add", bloom_add),
            ("bloom_contains", lambda: bf.contains_many(batches)),
            ("cms_add_seq", lambda: cms.add_all_seq(events)),
            ("hll_pfadd", hll_pfadd),
            ("bitset_mixed", bitset_mixed),
        ):
            row = profile_pass(name, fn, out_dir)
            row["card"] = card
            print(json.dumps(row), flush=True)
    finally:
        client.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
