"""One benchmark run: one process, one cell, one seed.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's deployment from the seed through the program's
public client (``redisson_tpu_torch``), warms it with the cell's own
traffic (``warmup_calls`` per client: the shapes the window will use),
then runs the mix's loop (``portbench/loops/``) for ``--seconds``.  With ``--trace 1`` it also
profiles a steady slice of the window and reports the per-layer metrics
in place of the end-to-end ones.  After the window it reads every row
back, frees the program, rebuilds the rows and bounds every checked
answer with the plain reference (``portbench/reference``), and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown``), and last ``checks``, each number compared
beside its limit, which also close standard error.

``--control <variant>`` puts the reference in the program's place:
``exact`` must come out correct, and a variant broken in one stated
guarantee must not (the benchmark's own runs never pass it).  It needs a card like any run:
``python -m portbench`` never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from portbench import counters, spec
from portbench.loop import Activity, run_clients
from portbench.trace import Slice
from portbench.traffic import ClientPlan, load_mix

FORBIDDEN = ("jax", "jaxlib", "flax", "redisson_tpu")
# The profiled slice: the window's first TRACE_SECONDS, at most
# TRACE_SHARE of it, so the trace stays small.
TRACE_SECONDS = 3.0
TRACE_SHARE = 0.5


@dataclass
class Run:
    """What a metric reader sees."""

    cell: dict
    config: dict
    mix: dict
    space: object
    kind: object
    seconds: float
    t_start: float
    t_end: float
    setup_s: float
    records: list
    before: Optional[dict] = None
    after: Optional[dict] = None
    profile: Optional[dict] = None
    peaks: dict = field(default_factory=dict)

    def window_calls(self) -> list:
        """Calls issued in the window and answered inside it."""
        return [r for r in self.records
                if r.phase == "window" and r.ok and r.t_done <= self.t_end]


def loaded_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(os.getcwd(), "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: str = spec.ROOT,
            bench_path: str = "BENCHMARK.json", control: Optional[str] = None,
            t_process: Optional[float] = None, log=print) -> dict:
    """Run one cell and return the result line as a dict (``None`` values
    for metrics that found nothing to read are left out)."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = spec.load_benchmark(bench_path)
    cell = spec.cell(workload, root)
    cfg = spec.config(cell["config"], root)
    mix = load_mix(spec.mix_path(cell["traffic"], root), root)
    loop = spec.loop(mix["loop"], root)
    kind = spec.kind(cfg["kind"], root)
    section = "per_layer" if trace else "end_to_end"
    wanted = spec.cell_metrics(bench, workload, section)
    readers = {m["name"]: spec.metric(m["name"], root) for m in wanted}
    families = sorted({f for r in readers.values() for f in getattr(r, "FAMILIES", ())})

    chips = int(cell["chips"])
    if device == "cuda":
        # A fresh process: each card's peak counts from zero.
        devices = [torch.device("cuda", i) for i in range(chips)]
    else:
        devices = [torch.device(device)]
    space = kind.Space(cfg, seed)
    client = None
    if control is not None:
        api = kind.ServerApi(space, devices[0], control)
    else:
        import redisson_tpu_torch as rt

        client = rt.create(kind.client_config(rt, cfg, device))
        api = kind.ProgramApi(client, space)
    try:
        setup_checks = api.setup()
        plans = [ClientPlan(mix, space, seed, c) for c in range(int(mix["clients"]))]
        warm = int(mix["warmup_calls"])
        records, errors = run_clients(loop, mix, plans, api.issue, 0, math.inf, warm, "warm")
        _sync(devices)
        activity = Activity() if trace else None
        tslice = Slice(devices) if trace and device == "cuda" else None
        if tslice is not None:
            # Started before the window: starting a profiler under load
            # takes seconds.  It covers the window's first seconds.
            tslice.start()
        t_start = time.perf_counter()
        setup_s = t_start - t_process
        t_end = t_start + seconds
        snaps: dict = {}
        if client is not None:
            snaps["before"] = counters.snapshot(client, families)

        def during():
            if tslice is not None:
                _sleep_until(t_start + min(TRACE_SECONDS, TRACE_SHARE * seconds))
                tslice.stop()
            _sleep_until(t_end)
            if client is not None:
                snaps["after"] = counters.snapshot(client, families)

        recs, errs = run_clients(loop, mix, plans, api.issue, warm, t_end, 1 << 62,
                                 "window", activity, during=during)
        records += recs
        errors += errs
        _sync(devices)
        peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0) \
            if device == "cuda" else 0
        profile = tslice.reduce(activity) if tslice is not None else None
        rows = api.rows()
    finally:
        if client is not None:
            client.shutdown()
    del api, client
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = dict(setup_checks)
    checks["calls_failed"] = (sum(1 for r in records if not r.ok), 0)
    checks.update(kind.check(space, plans, records, rows, devices[0]))
    del rows
    run = Run(cell, cfg, mix, space, kind, float(seconds), t_start, t_end, setup_s,
              records, snaps.get("before"), snaps.get("after"), profile)
    if device == "cuda":
        from portbench.peaks import peaks_for

        run.peaks = peaks_for(torch.cuda.get_device_name(devices[0]))
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = getattr(readers[m["name"]], "detail", None)
            if extra is not None:
                metrics[m["name"]].update(extra(run))
    window = [r for r in records if r.phase == "window"]
    info = {k: v for k, (v, lim) in checks.items() if lim is None}
    # The window's rate in every run, traced or not: their ratio is the
    # tracing's cost.
    info["window_ops_per_s"] = sum(r.n for r in run.window_calls()) / run.seconds
    info["window_calls"] = len(run.window_calls())
    per_s = [0] * int(math.ceil(run.seconds))
    for r in run.window_calls():
        per_s[min(len(per_s) - 1, int(r.t_done - run.t_start))] += r.n
    info["ops_by_second"] = per_s
    checks = {k: c for k, c in checks.items() if c[1] is not None}
    correct = all(v <= lim for v, lim in checks.values())
    out = {
        "correct": bool(correct),
        "attempted": int(sum(r.n for r in window)),
        "failed": int(sum(r.n for r in window if not r.ok)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(devices[0]) if device == "cuda" else device,
            "count": len(devices),
            "memory_peak_bytes": int(peak),
        },
    }
    if profile is not None:
        out["device"]["busy_s"] = profile["busy_s"]
        out["device"]["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    out["check_info"] = info
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    if profile is not None:
        log(f"trace: {profile['device_events']} device events, kernels "
            f"{profile['kernel_s']:.6f} s, busy {profile['busy_s']:.6f} s of "
            f"{profile['window_s']:.6f} s", file=sys.stderr)
    for e in errors[:3]:
        log(e, file=sys.stderr)
    return out


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def main(argv=None, t_process: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench",
                                 description="One run of one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="put the reference in the program's place: 'exact', or a variant "
                         "broken in one guarantee ('hash32' for Bloom, 'lost_update' for BitSet)")
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        print("portbench: --seconds must be positive", file=sys.stderr)
        return 2
    _cache_dirs()
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    np.seterr(over="ignore")
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  control=args.control, t_process=t_process)
    found = loaded_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, v in out["check_info"].items():
        print(f"info {name} {v}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
