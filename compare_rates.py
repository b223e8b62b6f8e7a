"""Phases 2 and 4 of chip_smoke.py for two checkouts, in turns on one card.

Each run is a fresh process in one checkout that imports that checkout's
``chip_smoke`` and runs its phase 2 (config 1: Bloom add and contains
keys/s at 1M keys, 1% FPP) and phase 4 (config 5: ``add_all_seq`` events/s
over 2M zipf(1.2) events through K1) on a fresh client, with every check
those phases make.  The runs go base, change, change, base (``--rounds``
repeats the four), so the two checkouts see the same card and the same
drift.  A change to host code on the hot path shows as a move in these
rates beyond the spread between the runs of one checkout.

    python3 compare_rates.py BASE_DIR [--change-dir DIR] [--seed N] [--rounds N]

Prints one JSON line per run and, last, a summary line per checkout with
the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import sys
import numpy as np
import chip_smoke as cs
import redisson_tpu_torch as rt
from redisson_tpu_torch.codecs import LongCodec
from redisson_tpu_torch.ops import _build

_build.build(["cms_seq"])
card = cs.nvidia_smi()
client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch())
try:
    rng = np.random.default_rng(int(sys.argv[1]))
    cs.phase_bloom(client, rng, card)
    cs.phase_cms(client, rng, card)
finally:
    client.shutdown()
"""

KEYS = {2: ("add_ops_per_s", "contains_ops_per_s"), 4: ("events_per_s",)}


def run(tree: str, seed: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", CHILD, str(seed)], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"compare_rates: the run in {tree} failed:\n{out.stderr[-4000:]}")
    rates, card = {}, None
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        for k in KEYS.get(rec.get("phase"), ()):
            rates[f"phase{rec['phase']}_{k}"] = rec[k]
            card = rec.get("card")
    if len(rates) != 3:
        raise SystemExit(f"compare_rates: the run in {tree} printed {sorted(rates)}")
    return {"tree": tree, **rates, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base_dir")
    ap.add_argument("--change-dir", default=".")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("compare_rates: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    for _ in range(args.rounds):
        for tree in (args.base_dir, args.change_dir, args.change_dir, args.base_dir):
            rec = run(tree, args.seed)
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    for tree in (args.base_dir, args.change_dir):
        mine = [r for r in runs if r["tree"] == tree]
        print(json.dumps({"summary": tree, "card": mine[0]["card"], **{
            k: [r[k] for r in mine] for k in mine[0] if k.startswith("phase")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
