"""Standalone server entry point — the redis-server-analog deployment
shape: ``python -m redisson_tpu_torch [--port P] [--device cuda|cpu] ...``
boots the engine on the card and serves RESP2/RESP3 over TCP until
SIGINT/SIGTERM, so foreign clients (redis-cli, redis-py, a stock
Redisson) can use the keyspace without any Python embedding.

On SIGINT/SIGTERM the server drains its connections (every acked reply
was dispatched), then the client shuts down, writing the final snapshot
to ``--snapshot-dir`` (sketch pools and ``grid_store.bin``), which the
next boot on the same directory restores.  ``--journal-dir`` adds the
op journal (the acked tail between snapshots survives a kill -9, and it
feeds the replication stream); ``--replica-of HOST:PORT`` boots a read
replica by full resync from that primary.  The port of
``redisson_tpu/__main__.py``; its per-core front door, cluster,
metrics-endpoint and federation flags wait for their modules.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m redisson_tpu_torch",
        description="redisson_tpu_torch standalone RESP server",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument(
        "--device", default="cuda",
        help="where the sketch pools live: cuda (default; refuses to start "
        "without a card) or cpu (the kernels' plain PyTorch versions)",
    )
    p.add_argument(
        "--config", help="YAML/JSON config file (Config.from_yaml)"
    )
    p.add_argument(
        "--snapshot-dir",
        help="restore-on-boot + snapshot-on-shutdown directory",
    )
    p.add_argument(
        "--snapshot-interval-s", type=float, default=0.0,
        help="arm periodic snapshots (requires --snapshot-dir)",
    )
    p.add_argument(
        "--journal-dir",
        help="op-journal directory: tail-of-log durability between "
        "snapshots, and the replication stream's source on a primary",
    )
    p.add_argument(
        "--replica-of", default=None, metavar="HOST:PORT",
        help="boot as a read-only replica of this primary: full-resync "
        "bootstrap (snapshot + stream tail), then follow the replication "
        "stream (requires a snapshot dir)",
    )
    p.add_argument("--max-connections", type=int, default=256)
    p.add_argument("--idle-timeout-s", type=float, default=300.0)
    p.add_argument(
        "--requirepass", default=None,
        help="require AUTH before any command (also settable via the "
        "config file's requirepass key)",
    )
    p.add_argument(
        "--no-resp-vectorize", action="store_true",
        help="disable front-door pipeline vectorization (fused runs + "
        "response cache) — semantics are identical either way",
    )
    p.add_argument(
        "--no-resp-reactor", action="store_true",
        help="serve thread-per-connection instead of the reactor pool — "
        "per-connection semantics are identical either way, but idle "
        "connections cost a thread each",
    )
    p.add_argument(
        "--resp-reactor-threads", type=int, default=None,
        help="reactor event-loop thread count (default from config, 1)",
    )
    p.add_argument(
        "--trace-sample-rate", type=float, default=None,
        help="distributed-trace head-sampling probability in [0, 1] "
        "(default 0 = tracing off; live via CONFIG SET "
        "trace-sample-rate / TRACE SAMPLE)",
    )
    p.add_argument(
        "--latency-monitor-threshold", type=int, default=None,
        help="arm the LATENCY monitor at this many milliseconds "
        "(0 = off, the redis default; live via CONFIG SET)",
    )
    args = p.parse_args(argv)

    import redisson_tpu_torch
    from redisson_tpu_torch import Config
    from redisson_tpu_torch.serve.resp import RespServer

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print(
                "redisson_tpu_torch: no CUDA device (pass --device cpu to "
                "serve from the CPU)",
                file=sys.stderr,
            )
            return 2
    if args.config:
        if not os.path.exists(args.config):
            p.error(f"--config file not found: {args.config}")
        cfg = Config.from_yaml(args.config)
    else:
        cfg = Config().use_gpu_sketch()
    cfg.gpu_sketch.device = args.device
    if args.snapshot_dir:
        cfg.snapshot_dir = args.snapshot_dir
    if args.snapshot_interval_s:
        # Applies to the EFFECTIVE dir (flag or config file) — silently
        # dropping the interval would fake-arm periodic snapshots.
        if not cfg.snapshot_dir:
            p.error("--snapshot-interval-s requires a snapshot dir "
                    "(--snapshot-dir or config file)")
        cfg.snapshot_interval_s = args.snapshot_interval_s
    if args.journal_dir:
        cfg.journal_dir = args.journal_dir
    if args.replica_of:
        cfg.replica_of = args.replica_of
    if args.trace_sample_rate is not None:
        if not 0.0 <= args.trace_sample_rate <= 1.0:
            p.error("--trace-sample-rate must be in [0, 1]")
        cfg.trace_sample_rate = args.trace_sample_rate
    if args.latency_monitor_threshold is not None:
        if args.latency_monitor_threshold < 0:
            p.error("--latency-monitor-threshold must be >= 0")
        cfg.latency_monitor_threshold_ms = args.latency_monitor_threshold
    if args.requirepass:
        cfg.requirepass = args.requirepass
    if args.no_resp_vectorize:
        cfg.resp_vectorize = False
    if args.no_resp_reactor:
        cfg.resp_reactor = False
    if args.resp_reactor_threads is not None:
        if args.resp_reactor_threads < 1:
            p.error("--resp-reactor-threads must be >= 1")
        cfg.resp_reactor_threads = args.resp_reactor_threads

    if cfg.replica_of:
        # Replica boot: pull the primary's snapshot and wipe local
        # durability state BEFORE the engine restores, so the process
        # comes up at one consistent (replid, offset) and never replays
        # stale local segments over the primary's snapshot.
        host_m, _, port_m = str(cfg.replica_of).rpartition(":")
        if not host_m or not port_m.isdigit():
            p.error("--replica-of needs HOST:PORT")
        if not cfg.snapshot_dir:
            p.error("--replica-of requires a snapshot dir "
                    "(--snapshot-dir or config file)")
        from redisson_tpu_torch.durability.replica import bootstrap_full_resync

        replid, snap_seq = bootstrap_full_resync(
            host_m, int(port_m), cfg.snapshot_dir, cfg.journal_dir,
            f"{args.host}:{args.port}", listening_port=args.port,
        )
        # The RESP door hands this to the ReplicaLink so its first PSYNC
        # continues from the restored cut instead of re-shipping the
        # snapshot it was just built from.
        cfg._repl_bootstrap_id = replid
        print(f"replica of {cfg.replica_of}: FULLRESYNC {replid} at seq {snap_seq}",
              flush=True)

    client = redisson_tpu_torch.create(cfg)
    server = RespServer(
        client,
        host=args.host,
        port=args.port,
        max_connections=args.max_connections,
        idle_timeout_s=args.idle_timeout_s,
    )
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    print(
        f"redisson-tpu-torch serving RESP on {server.host}:{server.port} "
        f"(device={client._engine.executor.device})",
        flush=True,
    )
    stop.wait()
    print("shutting down (snapshot-on-shutdown if configured)", flush=True)
    server.close()
    client.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
