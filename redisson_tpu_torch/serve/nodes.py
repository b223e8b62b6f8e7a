"""NodesGroup — → org/redisson/api/NodesGroup / RedisNodes (SURVEY.md
§2.3 admin row): per-node ping/info.  A node here is one shard of the
engine and names the torch device it lives on (the card, or the CPU when
the client was built with ``device="cpu"``); a sharded engine lists one
node per shard this process holds, each on its placement's device, with
its global shard number and this process's rank (the host engine: one
node on the host's CPU).  ``ping`` round-trips
a tiny computation through the node's device; the failure monitor pings
each distinct device once per sweep and reports every shard on it.

The port's copy of ``redisson_tpu/serve/nodes.py``.
"""

from __future__ import annotations

import time
from typing import Any

from redisson_tpu_torch.analysis import witness as _witness


class Node:
    def __init__(self, device, shard: int, process_index: int = 0):
        self._device = device
        self.shard = shard
        self.process_index = process_index

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else self._device.type

    @property
    def id(self) -> int:
        return self._device.index or 0

    @property
    def address(self) -> str:
        return f"{self.platform}:{self.id}"

    def ping(self, timeout_seconds: float = 30.0) -> bool:
        """One tiny device round trip (the PING health check analog),
        bounded by ``timeout_seconds`` — a wedged device returns False
        instead of hanging the health check."""
        import threading

        # One probe thread per NODE, reused across pings: a wedged device
        # parks its probe forever, and spawning a fresh thread per call
        # leaked one stuck thread per monitor sweep (unbounded on a
        # long-running server).  While the previous probe is still
        # parked, the device is by definition not answering — report
        # down WITHOUT stacking another probe behind it.
        prev = getattr(self, "_probe_thread", None)
        if prev is not None and prev.is_alive():
            return False
        result = [False]

        def probe():
            import torch

            try:
                x = torch.ones(8, dtype=torch.int32, device=self._device)
                # .item() synchronizes: the sum came back from the device.
                result[0] = int((x + 1).sum().item()) == 16
            except Exception:
                result[0] = False

        t = threading.Thread(target=probe, daemon=True)
        self._probe_thread = t
        t.start()
        t.join(timeout_seconds)
        return result[0] and not t.is_alive()

    def info(self) -> dict[str, Any]:
        """→ Node#info (INFO reply analog): device identity + memory."""
        import torch

        d = self._device
        out = {
            "id": self.id,
            "platform": self.platform,
            "device_kind": "cpu",
            "process_index": self.process_index,
            "shard": self.shard,
        }
        if d.type == "cuda":
            out["device_kind"] = torch.cuda.get_device_name(d)
            out["bytes_in_use"] = torch.cuda.memory_allocated(d)
            out["bytes_limit"] = torch.cuda.mem_get_info(d)[1]
        return out

    def time(self) -> float:
        """→ Node#time (TIME): host clock — devices carry no wall clock."""
        return time.time()


class NodeDownEvent:
    """Typed failure event: a shard's device stopped answering ping —
    the failedSlaveCheckInterval / PingConnectionHandler analog
    (SURVEY.md §5 failure row)."""

    def __init__(self, shard: int, address: str):
        self.shard = shard
        self.address = address

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"NodeDownEvent(shard={self.shard}, address={self.address!r})"


class NodeUpEvent:
    """Recovery counterpart of NodeDownEvent."""

    def __init__(self, shard: int, address: str):
        self.shard = shard
        self.address = address

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"NodeUpEvent(shard={self.shard}, address={self.address!r})"


class FailureMonitor:
    """Background monitor consuming ``Node.ping`` on an interval and
    surfacing dead/recovered shards as typed events — the topology-
    monitor loop of ClusterConnectionManager reduced to its pod-local
    substance.  Listeners receive NodeDownEvent exactly once per
    down-transition (and NodeUpEvent on recovery), not once per failed
    ping."""

    def __init__(self, nodes_group: "NodesGroup", interval_s: float = 1.0,
                 ping_timeout_s: float = 10.0):
        import threading

        self._ng = nodes_group
        self.interval_s = interval_s
        self.ping_timeout_s = ping_timeout_s
        self._listeners: list = []
        self._down: set[int] = set()
        self._stop = threading.Event()
        self._thread = None
        self._threading = threading
        # Serializes sweeps: a monitor thread whose stop() join timed out
        # (wedged ping) may overlap the next start()'s thread briefly —
        # the lock keeps _down/listener emission race-free until the old
        # thread sees its own stop event and exits.
        self._sweep_lock = _witness.named(
            threading.Lock(), "serve.nodes.sweep"
        )

    def add_listener(self, cb) -> None:
        """``cb(event)`` is invoked from the monitor thread."""
        self._listeners.append(cb)

    def down_shards(self) -> set:
        return set(self._down)

    def check_once(self) -> list:
        """One synchronous sweep (also what the thread loops); returns the
        events emitted."""
        with self._sweep_lock:
            return self._check_once_locked()

    def _check_once_locked(self) -> list:
        events = []
        alive: dict = {}  # address -> ping result: one probe per device
        for node in self._ng.get_nodes():
            if node.address not in alive:
                alive[node.address] = node.ping(self.ping_timeout_s)
            ok = alive[node.address]
            if not ok and node.shard not in self._down:
                self._down.add(node.shard)
                events.append(NodeDownEvent(node.shard, node.address))
            elif ok and node.shard in self._down:
                self._down.discard(node.shard)
                events.append(NodeUpEvent(node.shard, node.address))
        for ev in events:
            for cb in self._listeners:
                try:
                    cb(ev)
                except Exception:  # pragma: no cover — listener bug
                    pass
        return events

    def start(self) -> None:
        with self._sweep_lock:  # start/stop are thread-safe
            if self._thread is not None and self._thread.is_alive():
                if not self._stop.is_set():
                    return  # already running
            # Each thread closes over its OWN stop event: clearing a
            # shared event would resurrect a zombie thread whose stop()
            # join timed out on a wedged ping (it would loop forever
            # beside the new one).
            stop = self._threading.Event()
            self._stop = stop

            def loop():
                while not stop.wait(self.interval_s):
                    self.check_once()

            self._thread = self._threading.Thread(
                target=loop, name="rtpu-failure-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if not t.is_alive():
                self._thread = None


class NodesGroup:
    """→ RedissonClient#getNodesGroup."""

    def __init__(self, client):
        self._client = client

    def get_nodes(self) -> list[Node]:
        # One node per shard this process holds, each naming the device
        # its shard's placement lives on.
        eng = self._client._engine
        ex = getattr(eng, "executor", None)
        if ex is None:  # the host engine: one node, the host's CPU
            import torch

            return [Node(torch.device("cpu"), 0)]
        rank = getattr(getattr(ex, "ctx", None), "rank", 0)
        return [Node(d, s, rank) for s, d in eng.mesh_shards()]

    def ping_all(self) -> bool:
        nodes = self.get_nodes()
        return bool(nodes) and all(n.ping() for n in nodes)
