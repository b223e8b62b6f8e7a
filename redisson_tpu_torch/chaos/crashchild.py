"""Kill-−9 crash-soak child (the port's copy of
``redisson_tpu/chaos/crashchild.py``).

Run as ``python -m redisson_tpu_torch.chaos.crashchild --dir D --fsync P
--seed S --ops N [--device cuda|cpu]``: builds a journaled engine in D
on the card (``--device cpu`` for the CPU), applies a
DETERMINISTIC op stream derived from (seed), and prints one line per
ACKED op to stdout::

    ACK <index> <unix_time>

An op counts as acked only after its result resolved — under
``appendfsync always`` that means its journal record is fsynced, so
every ACK line the parent reads names a write recovery MUST restore.
The parent kills this process with SIGKILL at a moment drawn from a
seeded RNG, recovers the directory into a fresh
engine, and verifies the recovered device rows are bit-identical to a
golden engine fed the same op-stream prefix.

The op stream is pure function of the seed (no wall-clock, no
randomness outside ``random.Random(seed)``), so parent and child agree
on op ``i`` exactly.
"""

from __future__ import annotations

import argparse
import random
import sys
import time


def op_stream(seed: int, n: int):
    """Deterministic mixed workload over four objects (one per sketch
    kind) plus occasional structural ops.  Yields (kind, payload)."""
    rng = random.Random(seed)
    for i in range(n):
        roll = rng.random()
        if roll < 0.40:
            yield ("bloom_add", [rng.randrange(1 << 30) for _ in range(8)])
        elif roll < 0.60:
            yield ("hll_add", [rng.randrange(1 << 30) for _ in range(8)])
        elif roll < 0.80:
            yield (
                "bitset_set",
                ([rng.randrange(4096) for _ in range(4)], rng.random() < 0.8),
            )
        elif roll < 0.95:
            yield (
                "cms_add",
                (rng.randrange(1 << 20), 1 + rng.randrange(5)),
            )
        elif roll < 0.98:
            yield ("bitset_flip", [rng.randrange(4096) for _ in range(4)])
        else:
            yield ("expire_far", None)  # TTL far in the future: replayed


def build_client(directory: str, fsync: str, residency: bool = False,
                 device: str = "cuda"):
    import redisson_tpu_torch
    from redisson_tpu_torch import Config
    from redisson_tpu_torch.codecs import LongCodec

    cfg = Config().set_codec(LongCodec()).use_gpu_sketch(
        device=device, min_bucket=64
    )
    cfg.snapshot_dir = directory + "/snap"
    cfg.journal_dir = directory + "/journal"
    cfg.journal_fsync = fsync
    if residency:
        # Residency soak: blob dir armed; transitions are
        # FORCED from the op stream (budget stays 0 — no background
        # thread, so parent and child stay deterministic).
        cfg.gpu_sketch.residency_dir = directory + "/blobs"
    return redisson_tpu_torch.create(cfg)


def apply_ops(client, seed: int, n: int, ack=None, snapshot_every: int = 0,
              residency_every: int = 0):
    """Apply the deterministic stream; calls ``ack(i)`` after each op's
    result resolves.  ``snapshot_every`` > 0 takes a mid-stream
    snapshot (exercises snapshot-coordinated truncation under load);
    ``residency_every`` > 0 forces a deterministic residency-ladder
    transition (demote / demote+spill / promote, rotating over the four
    objects) every that-many ops — the kill -9 can land mid-demotion or
    mid-spill, which is exactly the window the residency soak proves
    safe.  Transitions never change logical state (exact codecs), so
    the golden comparison engine needs none of this."""
    bf = client.get_bloom_filter("soak-bf")
    bf.try_init(100_000, 0.01)
    h = client.get_hyper_log_log("soak-hll")
    bs = client.get_bit_set("soak-bs")
    cms = client.get_count_min_sketch("soak-cms")
    cms.try_init(4, 1024)
    for i, (kind, payload) in enumerate(op_stream(seed, n)):
        if kind == "bloom_add":
            bf.add_all(payload)
        elif kind == "hll_add":
            h.add_all(payload)
        elif kind == "bitset_set":
            idxs, value = payload
            bs.set_many(idxs, value)
        elif kind == "cms_add":
            key, w = payload
            cms.add(key, w)
        elif kind == "bitset_flip":
            for ix in payload:
                bs.flip(ix)
        elif kind == "expire_far":
            client._engine.expire_at("soak-bs", time.time() + 3600.0)
        if ack is not None:
            ack(i)
        if residency_every and (i + 1) % residency_every == 0:
            rm = client._engine.residency
            k = (i + 1) // residency_every
            name = ("soak-bf", "soak-hll", "soak-bs", "soak-cms")[k % 4]
            if k % 3 == 0:
                rm.demote(name)
            elif k % 3 == 1:
                rm.demote(name)
                rm.spill(name)
            else:
                rm.promote(name)
        if snapshot_every and (i + 1) % snapshot_every == 0:
            client._engine.snapshot(client.config.snapshot_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--fsync", default="always")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", type=int, default=400)
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--residency-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    client = build_client(
        args.dir, args.fsync, residency=args.residency_every > 0,
        device=args.device,
    )

    def ack(i: int) -> None:
        # One complete line per acked op; flush so the parent's pipe
        # sees it the moment the ack happened (a SIGKILL can tear at
        # most the line in flight — the parent drops partial lines).
        sys.stdout.write(f"ACK {i} {time.time():.6f}\n")
        sys.stdout.flush()

    print("READY", flush=True)
    apply_ops(client, args.seed, args.ops, ack=ack,
              snapshot_every=args.snapshot_every,
              residency_every=args.residency_every)
    print("DONE", flush=True)
    client.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover — subprocess entry
    raise SystemExit(main())
