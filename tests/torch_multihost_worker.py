"""One process of the port's two-process engine (the counterpart of
``tests/multihost_worker.py``): it joins the torch.distributed group
through the engine's own ``coordinator_address`` config, holds 4 of the
8 global shards, and drives the SAME op stream as its peer, in lockstep
(``coalesce=False``).  Every dispatch crosses processes: the partition
is computed on both, each runs its own shards, results are all-gathered
and rows travel from their owners.

Run: ``python tests/torch_multihost_worker.py <process_id> <port> <out_dir>``.
Prints one ``MH-OK <json>`` line on success: the stream's results, the
group's backend and this process's devices, and the lockstep guards as
found; the stream's snapshot lands in ``<out_dir>/p<process_id>``.

``stream`` uses only the public client API, so the parent test runs it
on a single-process JAX client too.
"""

import json
import os
import sys
import warnings

import numpy as np

S = 8
# Tenant rows are handed out from row 0 up, and row r lives on shard
# r % 8: the first four objects of a kind sit in process 0, the next four
# in process 1, so merges between them cross processes.
N_PER_KIND = 6


def stream(client, snapshot_dir=None) -> dict:
    """The multi-host worker's stream (Bloom, HLL, BitSet, with
    ``count`` and ``cardinality``), then a cross-process BITOP, PFMERGE
    and CMS.MERGE, a lockstep snapshot, and ``change_topology`` to 4
    shards and to 1.  Returns every result."""
    out = {}
    bf = client.get_bloom_filter("mh-bf")
    bf.try_init(50_000, 0.01)
    out["bf_added"] = int(bf.add_all(np.arange(1000, dtype=np.uint64)))
    got = bf.contains_each(np.arange(2000, dtype=np.uint64))
    out["bf_hits"] = [bool(x) for x in got]
    out["bf_count"] = int(bf.count())
    h = client.get_hyper_log_log("mh-hll")
    h.add_all(np.arange(20_000, dtype=np.uint64))
    out["hll_count"] = int(h.count())
    bs = client.get_bit_set("mh-bs")
    bs.set_many(np.arange(0, 4096, 7, dtype=np.uint32))
    out["bs_card"] = int(bs.cardinality())
    # Objects on both processes' shards, then merges across them.
    rng = np.random.default_rng(17)
    for i in range(N_PER_KIND):
        client.get_hyper_log_log(f"x-hll{i}").add_all(
            rng.integers(0, 1 << 40, 3000).astype(np.uint64))
        client.get_bit_set(f"x-bs{i}").set_many(
            rng.integers(0, 1 << 14, 2000).astype(np.uint32))
        cm = client.get_count_min_sketch(f"x-cm{i}")
        cm.try_init(4, 1 << 10)
        cm.add_all(rng.integers(0, 300, 500).astype(np.uint64))
    client.get_hyper_log_log("x-hll0").merge_with("x-hll4", "x-hll5")
    out["pfmerge_count"] = int(client.get_hyper_log_log("x-hll0").count())
    client.get_bit_set("x-bs5").and_op("x-bs1")
    client.get_bit_set("x-bs2").or_op("x-bs4")
    out["bitop_card"] = [int(client.get_bit_set(f"x-bs{i}").cardinality())
                         for i in (5, 2)]
    client.get_count_min_sketch("x-cm1").merge("x-cm4", "x-cm5")
    out["cms_merged"] = [int(v) for v in client.get_count_min_sketch("x-cm1").estimate_all(
        np.arange(300, dtype=np.uint64))]
    if snapshot_dir is not None:
        client.snapshot(snapshot_dir)
    # A live reshard to 4 global shards (2 in each process), then to one
    # (a whole replica in each process): every answer stays.
    probe = np.arange(500, 1500, dtype=np.uint64)
    for s in (4, 1):
        assert client.change_topology(s)
        out[f"reshard_{s}"] = [
            int(bf.count()), int(h.count()), int(bs.cardinality()),
            int(client.get_hyper_log_log("x-hll0").count()),
            [bool(x) for x in bf.contains_each(probe)],
        ]
    return out


def main() -> None:
    pid, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    def config(**kw):
        return rt.Config().set_codec(LongCodec()).use_gpu_sketch(
            device="cpu", num_shards=S, min_bucket=64, coalesce=False,
            coordinator_address=f"127.0.0.1:{port}", num_processes=2,
            process_id=pid, **kw)

    client = rt.create(config())
    eng = client._engine
    ctx = eng.executor.ctx
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    assert (ctx.lo, ctx.hi) == (4 * pid, 4 * pid + 4), (ctx.lo, ctx.hi)
    res = stream(client, os.path.join(out_dir, f"p{pid}"))
    # The lockstep guards, and a second engine that joins no group.
    guards = {"nearcache_locked_off": eng.nearcache.locked_off,
              "nearcache_enabled": eng.nearcache.enabled,
              "coalescer": eng.coalescer is not None,
              "owns_group": eng._owns_process_group}
    second_cfg = config()
    second_cfg.snapshot_dir = os.path.join(out_dir, f"second-p{pid}")
    second_cfg.snapshot_interval_s = 5.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        second = rt.create(second_cfg)
    guards["second_owns_group"] = second._engine._owns_process_group
    guards["second_snapshotter"] = second._engine._snapshotter is not None
    guards["snapshot_warning"] = any("periodic snapshots are disabled" in str(w.message)
                                     for w in caught)
    second.shutdown()
    # The first engine's group outlives the second's shutdown.
    res["after_second"] = int(client.get_bloom_filter("mh-bf").count())
    client.shutdown()
    guards["group_destroyed"] = not dist.is_initialized()
    report = {"results": res, "guards": guards, "backend": ctx.group.backend,
              "devices": [str(d) for d in ctx.devices]}
    print("MH-OK " + json.dumps(report, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
