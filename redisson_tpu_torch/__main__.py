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
replica by full resync from that primary.

``--frontdoor-processes K`` serves with K worker processes sharing the
port via SO_REUSEPORT (serve/multicore.py): this process becomes a pure
supervisor that spawns them (each its own CUDA context; all on
``cuda:0`` when the node has fewer cards than workers), forwards
SIGTERM/SIGINT and reaps them; with ``--metrics-port N`` it serves their
metrics merged on N.  ``--federate`` runs only that merged endpoint over
listed members.

``--cluster`` serves one node of a slot-sharded cluster (cluster/door.py:
-MOVED/-ASK redirects, hash tags, live slot migration):
``--cluster-topology FILE`` (the JSON every node shares; cluster/
supervisor.py writes one) with ``--cluster-myid``, or ``--cluster-slots
0-5460`` for a node alone; ``--cluster-announce HOST:PORT`` is the address
redirects name; ``--cluster-node-timeout-ms`` the failover agent's
failure-detection window (every cluster node runs the agent: primaries
vote, a replica of a dead primary runs the election).  With
``--frontdoor-processes K`` the cluster flags reach every worker, and
-MOVED comes only from the owning worker's door after the in-node
handoff.  ``--rebalance`` arms the autonomous rebalancer (cluster/
rebalancer.py: heat from every primary's CLUSTER LOADMAP, waves of slot
moves on the coordinator) and ``--doctor`` the fleet doctor (obs/
doctor.py: the continuous invariant sweep and the WAIT-fenced canary);
both require ``--cluster``.  The port of ``redisson_tpu/__main__.py``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _serve_multicore(args, nworkers: int) -> int:
    """Per-core front-door parent: a pure supervisor — no engine, no RESP
    door of its own.  Spawns K worker processes sharing (host, port) via
    SO_REUSEPORT, optionally fronts their per-worker metrics endpoints
    with ONE federated exposition (worker labels ride the federation
    plane's node label), forwards SIGTERM/SIGINT, and reaps every child
    before exiting."""
    from redisson_tpu_torch.serve.multicore import MulticoreNode

    extra = [
        "--max-connections", str(args.max_connections),
        "--idle-timeout-s", str(args.idle_timeout_s),
    ]
    if args.config:
        extra += ["--config", args.config]
    if args.snapshot_dir:
        extra += ["--snapshot-dir", args.snapshot_dir]
    if args.snapshot_interval_s:
        extra += ["--snapshot-interval-s", str(args.snapshot_interval_s)]
    if args.requirepass:
        extra += ["--requirepass", args.requirepass]
    if args.enable_python_scripts:
        extra += ["--enable-python-scripts"]
    if args.no_resp_vectorize:
        extra += ["--no-resp-vectorize"]
    if args.no_resp_reactor:
        extra += ["--no-resp-reactor"]
    if args.journal_dir:
        extra += ["--journal-dir", args.journal_dir]
    if args.replica_of:
        extra += ["--replica-of", args.replica_of]
    if args.resp_reactor_threads is not None:
        extra += ["--resp-reactor-threads", str(args.resp_reactor_threads)]
    if args.trace_sample_rate is not None:
        extra += ["--trace-sample-rate", str(args.trace_sample_rate)]
    if args.latency_monitor_threshold is not None:
        extra += [
            "--latency-monitor-threshold",
            str(args.latency_monitor_threshold),
        ]
    if args.cluster:
        extra += ["--cluster"]
    if args.rebalance:
        extra += ["--rebalance"]
    if args.doctor:
        extra += ["--doctor"]
    for val, flag in (
        (args.cluster_slots, "--cluster-slots"),
        (args.cluster_topology, "--cluster-topology"),
        (args.cluster_myid, "--cluster-myid"),
        (args.cluster_announce, "--cluster-announce"),
        (args.cluster_node_timeout_ms, "--cluster-node-timeout-ms"),
    ):
        if val is not None:
            extra += [flag, str(val)]

    # Handlers first: a SIGTERM while the workers start must still reap
    # them (the node shuts down as soon as startup returns).
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    node = MulticoreNode(
        nworkers, host=args.host, port=args.port, device=args.device,
        metrics_port=args.metrics_port, extra_args=extra,
    )
    fed = None
    if args.metrics_port is not None:
        from redisson_tpu_torch.obs.federate import start_federation_endpoint

        fed = start_federation_endpoint(
            [f"{args.host}:{mp}" for mp in node.metrics_ports],
            host=args.host, port=args.metrics_port,
        )
        print(
            f"federated worker metrics on "
            f"http://{fed.host}:{fed.port}/metrics",
            flush=True,
        )
    print(
        f"redisson-tpu-torch serving RESP on {node.host}:{node.port} "
        f"[{nworkers} SO_REUSEPORT front-door workers, device={args.device}]",
        flush=True,
    )
    stop.wait()
    print("shutting down front-door workers", flush=True)
    if fed is not None:
        fed.close()
    clean = node.shutdown()
    return 0 if clean else 1


def _serve_federation(args, p) -> int:
    """Standalone federation mode: just the merged metrics endpoint — no
    engine, no torch import, no RESP door."""
    if args.metrics_port is None:
        p.error("--federate requires --metrics-port")
    from redisson_tpu_torch.obs.federate import start_federation_endpoint

    targets = [t.strip() for t in args.federate.split(",") if t.strip()]
    srv = start_federation_endpoint(
        targets, host=args.host, port=args.metrics_port
    )
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    print(
        f"federated metrics on http://{srv.host}:{srv.port}/metrics "
        f"({len(targets)} member node(s))",
        flush=True,
    )
    stop.wait()
    srv.close()
    return 0


def _device_of(client) -> str:
    """Where the client's sketches live: the card engine's device, or
    ``host`` for the host engine."""
    ex = getattr(client._engine, "executor", None)
    return "host" if ex is None else str(ex.device)


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
    p.add_argument(
        "--enable-python-scripts", action="store_true",
        help="allow RESP EVAL/EVALSHA/SCRIPT/FUNCTION/FCALL (script "
        "bodies are Python — RCE for anyone who can reach the socket; "
        "refused unless --requirepass is set or the bind is loopback)",
    )
    p.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve the Prometheus text exposition on this port at "
        "/metrics; omitted = no endpoint",
    )
    p.add_argument(
        "--federate", default=None, metavar="HOST:PORT,...",
        help="federation-only mode: no engine, no RESP door — scrape the "
        "listed member /metrics endpoints per request and serve ONE "
        "merged exposition (node label per member) on --metrics-port",
    )
    p.add_argument(
        "--cluster", action="store_true",
        help="enable cluster mode: the door speaks the 16384-slot "
        "redirect protocol (CLUSTER, -MOVED/-ASK, hash tags, live slot "
        "migration) and the node runs the failover agent",
    )
    p.add_argument(
        "--cluster-slots", default=None,
        help="slot range(s) this node owns when no topology file is "
        "given, e.g. '0-5461' or '0-99,200-299' (default: all 16384)",
    )
    p.add_argument(
        "--cluster-topology", default=None,
        help="JSON topology file ({'nodes': [{'id','host','port',"
        "'slots'}]}) shared by every node — the supervisor writes one",
    )
    p.add_argument(
        "--cluster-myid", default=None,
        help="this node's id in the topology (default: announce addr)",
    )
    p.add_argument(
        "--cluster-announce", default=None,
        help="host:port other nodes/clients are redirected to "
        "(default: the bind address; set when behind NAT/containers)",
    )
    p.add_argument(
        "--cluster-node-timeout-ms", type=int, default=None,
        help="failure-detection window of the cluster bus: a peer silent "
        "this long is marked failed; replicas of a failed primary start "
        "a failover election (default 1500)",
    )
    p.add_argument(
        "--rebalance", action="store_true",
        help="arm the autonomous rebalancer (docs/clustering.md "
        "'Autonomous rebalancing'): the node scrapes the fleet's CLUSTER "
        "LOADMAPs into a smoothed per-slot heat model and, when "
        "coordinator, migrates slots to level the load; requires --cluster",
    )
    p.add_argument(
        "--doctor", action="store_true",
        help="arm the fleet doctor (docs/observability.md 'Fleet "
        "doctor'): a continuous invariant sweep — slot ownership, "
        "replication monotonicity, stuck migrations — plus a black-box "
        "WAIT-fenced canary; the coordinator (lowest-id alive primary) "
        "audits, findings surface via CLUSTER DOCTOR; requires --cluster",
    )
    p.add_argument(
        "--frontdoor-processes", type=int, default=None,
        help="per-core front door: serve with this many processes sharing "
        "the port via SO_REUSEPORT, each owning 1/K of the slot range "
        "behind an in-node handoff map (all on one card when the node has "
        "fewer cards than K); platforms without SO_REUSEPORT fall back "
        "to 1 with a logged INFO line",
    )
    # Internal worker-mode flags: the supervisor parent stamps these
    # into each spawned worker (serve/multicore.py MulticoreNode).
    p.add_argument("--frontdoor-workers", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--frontdoor-index", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--frontdoor-dir", default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.federate:
        return _serve_federation(args, p)

    import redisson_tpu_torch
    from redisson_tpu_torch import Config
    from redisson_tpu_torch.serve.resp import RespServer

    if args.config:
        if not os.path.exists(args.config):
            p.error(f"--config file not found: {args.config}")
        cfg = Config.from_yaml(args.config)
    else:
        cfg = Config().use_gpu_sketch()
    # A config file may choose the host engine (host_sketch: true), which
    # needs no card; the card engine refuses to start without one.
    if cfg.gpu_sketch.enabled and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print(
                "redisson_tpu_torch: no CUDA device (pass --device cpu to "
                "serve from the CPU)",
                file=sys.stderr,
            )
            return 2
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
    if args.enable_python_scripts:
        cfg.enable_python_scripts = True
    if args.no_resp_vectorize:
        cfg.resp_vectorize = False
    if args.no_resp_reactor:
        cfg.resp_reactor = False
    if args.resp_reactor_threads is not None:
        if args.resp_reactor_threads < 1:
            p.error("--resp-reactor-threads must be >= 1")
        cfg.resp_reactor_threads = args.resp_reactor_threads
    if args.cluster:
        cfg.cluster_enabled = True
    if args.rebalance:
        if not cfg.cluster_enabled:
            p.error("--rebalance requires --cluster (or a config file "
                    "with cluster_enabled: true)")
        cfg.rebalance_enabled = True
    if args.doctor:
        if not cfg.cluster_enabled:
            p.error("--doctor requires --cluster (or a config file "
                    "with cluster_enabled: true)")
        cfg.doctor_enabled = True
    for flag, key in (
        (args.cluster_slots, "cluster_slots"),
        (args.cluster_topology, "cluster_topology"),
        (args.cluster_myid, "cluster_node_id"),
        (args.cluster_announce, "cluster_announce"),
        (args.cluster_node_timeout_ms, "cluster_node_timeout_ms"),
    ):
        if flag is not None:
            if not cfg.cluster_enabled:
                p.error("--cluster-* flags require --cluster (or a "
                        "config file with cluster_enabled: true)")
            setattr(cfg, key, flag)

    # Per-core front door.  Parent shape: K > 1 and no worker index —
    # this process becomes a pure supervisor that spawns K worker
    # children sharing the port via SO_REUSEPORT (no engine of its own).
    # Worker shape: the internal flags stamp this process as worker i of
    # K.  No-SO_REUSEPORT platforms degrade to K=1 here
    # (effective_processes logs the INFO frontdoor line).
    fd_req = (
        args.frontdoor_processes
        if args.frontdoor_processes is not None
        else cfg.frontdoor_processes
    )
    if args.frontdoor_index is None and (fd_req or 1) > 1:
        from redisson_tpu_torch.serve import multicore

        fd_k = multicore.effective_processes(fd_req)
        if fd_k > 1:
            return _serve_multicore(args, fd_k)
    if args.frontdoor_index is not None:
        from redisson_tpu_torch.serve.multicore import worker_device_indices

        cfg.frontdoor_workers = max(2, int(args.frontdoor_workers))
        cfg.frontdoor_index = args.frontdoor_index
        cfg.frontdoor_dir = args.frontdoor_dir
        # Durability dirs split per worker — K journals/snapshot sets,
        # one per slot-range owner, never one contended set.
        sub = f"worker{args.frontdoor_index}"
        if cfg.snapshot_dir:
            cfg.snapshot_dir = os.path.join(cfg.snapshot_dir, sub)
            os.makedirs(cfg.snapshot_dir, exist_ok=True)
        if cfg.journal_dir:
            cfg.journal_dir = os.path.join(cfg.journal_dir, sub)
            os.makedirs(cfg.journal_dir, exist_ok=True)
        # Device pinning: each worker takes its contiguous 1/K of the
        # node's cards as its device_indices when there are that many
        # (unless the config names a slice); otherwise every worker shares
        # the default card.  A failure to enumerate is an error, never a
        # quiet fallback.
        if args.device.startswith("cuda") and cfg.gpu_sketch.device_indices is None:
            import torch

            idx = worker_device_indices(
                args.device, cfg.frontdoor_index, cfg.frontdoor_workers,
                torch.cuda.device_count(),
            )
            if idx is not None:
                cfg.gpu_sketch.device_indices = idx
                torch.cuda.set_device(idx[0])

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
            cfg.cluster_node_id or f"{args.host}:{args.port}",
            listening_port=args.port,
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
    if server.cluster is not None:
        # Automatic failover: every cluster node runs the bus agent —
        # primaries to vote, replicas to detect their primary's death and
        # run the election.  server.close() stops it.
        from redisson_tpu_torch.cluster.failover import FailoverAgent

        FailoverAgent(
            server,
            node_timeout_s=float(cfg.cluster_node_timeout_ms or 1500) / 1000.0,
            ping_interval_s=float(cfg.cluster_ping_interval_ms or 300) / 1000.0,
        ).start()
        if cfg.rebalance_enabled:
            # Autonomous rebalancer: observe everywhere, execute on the
            # coordinator.  server.close() stops it.
            from redisson_tpu_torch.cluster.rebalancer import RebalanceAgent

            RebalanceAgent(
                server,
                interval_s=float(cfg.rebalance_interval_ms or 1000) / 1000.0,
                threshold=float(cfg.rebalance_threshold or 1.3),
                max_moves=int(cfg.rebalance_max_moves or 8),
                pace_s=float(cfg.rebalance_pace_ms or 0) / 1000.0,
                cooldown_s=float(cfg.rebalance_cooldown_ms or 0) / 1000.0,
            ).start()
        if cfg.doctor_enabled:
            # Fleet doctor: probe everywhere, audit on the coordinator.
            # server.close() stops it.
            from redisson_tpu_torch.obs.doctor import FleetDoctor

            FleetDoctor(
                server,
                interval_s=float(cfg.doctor_interval_ms or 1000) / 1000.0,
                stuck_slot_s=float(cfg.doctor_stuck_slot_ms or 30000) / 1000.0,
                lag_bound_ops=int(cfg.doctor_lag_bound_ops or 10000),
                canary=bool(cfg.doctor_canary),
            ).start()
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = client.start_metrics_endpoint(
            host=args.host, port=args.metrics_port
        )
        print(
            f"metrics on http://{metrics_srv.host}:{metrics_srv.port}/metrics",
            flush=True,
        )
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    mode = ""
    if server.multicore is not None:
        mode = (f" [front-door worker {server.multicore.index} of "
                f"{server.multicore.nworkers}]")
    if server.cluster is not None:
        door = server.cluster
        mode += (f" [cluster node {door.myid}, "
                 f"{door.slotmap.owned_count(door.myid)}/16384 slots]")
    print(
        f"redisson-tpu-torch serving RESP on {server.host}:{server.port} "
        f"(device={_device_of(client)}){mode}",
        flush=True,
    )
    stop.wait()
    print("shutting down (snapshot-on-shutdown if configured)", flush=True)
    server.close()
    client.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
