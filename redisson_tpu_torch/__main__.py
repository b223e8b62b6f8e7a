"""Standalone server entry point — the redis-server-analog deployment
shape: ``python -m redisson_tpu_torch [--port P] [--device cuda|cpu] ...``
boots the engine on the card and serves RESP2/RESP3 over TCP until
SIGINT/SIGTERM, so foreign clients (redis-cli, redis-py, a stock
Redisson) can use the keyspace without any Python embedding.

On SIGINT/SIGTERM the server drains its connections (every acked reply
was dispatched), then the client shuts down, writing the final snapshot
to ``--snapshot-dir`` (sketch pools and ``grid_store.bin``), which the
next boot on the same directory restores.  The port of
``redisson_tpu/__main__.py``; its per-core front door, replication,
cluster, metrics-endpoint and federation flags wait for their modules.
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
