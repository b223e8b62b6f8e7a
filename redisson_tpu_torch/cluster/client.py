"""Slot-aware cluster client — the direct client's routing half: a RESP
wire client that keeps one connection per node, routes every command by
its keys' CRC16 slot, follows the redirect protocol, and scatter/gathers
multi-slot batches.

Redirect contract:

- ``-MOVED`` → refresh the WHOLE slot table from the cluster (ownership
  changed durably) and retry the command exactly ONCE;
- ``-ASK`` → send ``ASKING`` + the command to the named node, WITHOUT
  touching the slot table (a one-shot exception during migration);
- ``-TRYAGAIN`` → bounded backoff-retry (a multi-key op straddling a
  half-migrated slot resolves within the migration);
- multi-key commands whose keys hash to different slots raise
  :class:`CrossSlotError` client-side before any bytes move (hash tags
  ``{...}`` are the co-location tool).

``execute_many`` is the pipelined scatter/gather: a batch splits by
node, each node's leg ships as ONE pipelined request on that node's
connection (legs run concurrently on threads), and replies demux back
into submission order; per-command redirects are chased individually
after the gather.

Thread safety: each node connection serializes request/response cycles
under its own lock; the table swaps atomically.  No torch imports —
client processes fork this without touching the device runtime.

The port's copy of ``redisson_tpu/cluster/client.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import socket
import threading
import time

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slots import command_keys, key_slot
from redisson_tpu_torch.obs import trace as _trace
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange


class ClusterError(Exception):
    pass


class CrossSlotError(ClusterError):
    pass


class ClusterDownError(ClusterError):
    pass


def _parse_redirect(msg: str):
    """('MOVED'|'ASK', slot, (host, port)) from a redirect error."""
    kind, slot, addr = msg.split(" ", 2)
    host, _, port = addr.rpartition(":")
    return kind, int(slot), (host, int(port))


class _NodeConn:
    """One pooled connection: a socket plus the request/response lock
    that keeps concurrent callers' reply streams from interleaving."""

    def __init__(self, addr, timeout_s: float, password=None):
        self.addr = addr
        self._lock = _witness.named(threading.Lock(), "cluster.client.conn")
        sock = socket.create_connection(addr, timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        if password is not None:
            auth = self.request([[b"AUTH", password.encode()
                                  if isinstance(password, str)
                                  else password]])[0]
            if isinstance(auth, ReplyError):
                sock.close()
                raise ClusterError(f"AUTH failed on {addr}: {auth}")

    def request(self, cmds) -> list:
        """Ship ``cmds`` as one pipelined write, return the decoded
        replies in order (errors as ReplyError instances).  The lock IS
        the wire serialization: one request/response cycle at a time
        per socket.  An OSError (timeout included) leaves the socket
        DESYNCED — callers must drop this connection, never retry it
        (ClusterClient._request does)."""
        with self._lock:
            return exchange(self._sock, cmds)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class ClusterClient:
    """Slot-aware RESP client over N cluster nodes."""

    def __init__(self, seeds, password=None, timeout_s=10.0, obs=None,
                 tryagain_attempts=8, tryagain_backoff_s=0.02,
                 tracer=None, deadnode_attempts=10,
                 deadnode_backoff_s=0.1):
        if not seeds:
            raise ValueError("at least one seed (host, port) required")
        self._seeds = [tuple(s) for s in seeds]
        self._password = password
        self._timeout_s = timeout_s
        self.obs = obs
        # Distributed tracing: with a Tracer attached, this
        # client is the HEAD of the trace — execute/execute_many
        # head-sample a client root span, mint one child span per
        # scatter leg, and prepend the RTPU.TRACE wire prelude so each
        # node's door stitches its serving-side spans (reactor tick,
        # vectorizer, coalescer phases, launches) into the same trace.
        self.tracer = tracer
        self._tryagain_attempts = tryagain_attempts
        self._tryagain_backoff_s = tryagain_backoff_s
        # Failover window: a dead node costs a connect
        # failure per touch until the takeover broadcast lands in some
        # survivor's CLUSTER SLOTS — execute() rides it out with
        # refresh-and-retry instead of surfacing the first OSError.
        self._deadnode_attempts = deadnode_attempts
        self._deadnode_backoff_s = deadnode_backoff_s
        self._table_lock = _witness.named(
            threading.Lock(), "cluster.client.table"
        )
        self._slots: list = [None] * 16384  # slot -> (host, port)
        self._conns: dict = {}  # (host, port) -> _NodeConn
        self._pool = None  # lazy scatter-leg executor (see _executor)
        self.stats = {
            "moved": 0, "ask": 0, "tryagain": 0,
            "scatter_batches": 0, "scatter_legs": 0,
            "table_refreshes": 0, "deadnode_retries": 0,
        }
        self.refresh_slots()

    # -- topology ----------------------------------------------------------

    def _known_addrs(self) -> list:
        with self._table_lock:
            known = list(self._conns)
        out = list(self._seeds)
        out += [a for a in known if a not in out]
        return out

    def refresh_slots(self) -> None:
        """Rebuild the slot table via ``CLUSTER SLOTS`` from the first
        reachable node (seeds first, then every known node)."""
        last_err: Exception = ClusterDownError("no seeds")
        for addr in self._known_addrs():
            try:
                reply = self._request(addr, [[b"CLUSTER", b"SLOTS"]])[0]
            except (OSError, ClusterError) as e:
                last_err = e
                continue
            if isinstance(reply, ReplyError):
                last_err = ClusterError(str(reply))
                continue
            table: list = [None] * 16384
            for entry in reply:
                start, end, master = entry[0], entry[1], entry[2]
                node_addr = (master[0].decode(), int(master[1]))
                for s in range(int(start), int(end) + 1):
                    table[s] = node_addr
            with self._table_lock:
                self._slots = table
                self.stats["table_refreshes"] += 1
            return
        raise ClusterDownError(
            f"could not refresh slot table from any node: {last_err}"
        )

    def slot_addr(self, slot: int):
        with self._table_lock:
            return self._slots[slot]

    def _conn(self, addr) -> _NodeConn:
        with self._table_lock:
            conn = self._conns.get(addr)
        if conn is not None:
            return conn
        # Connect OUTSIDE the table lock (network under a shared lock
        # would stall every router); losers of the install race close.
        fresh = _NodeConn(addr, self._timeout_s, self._password)
        with self._table_lock:
            conn = self._conns.get(addr)
            if conn is None:
                self._conns[addr] = fresh
                return fresh
        fresh.close()
        return conn

    def _drop_conn(self, addr) -> None:
        with self._table_lock:
            conn = self._conns.pop(addr, None)
        if conn is not None:
            conn.close()

    def _request(self, addr, cmds) -> list:
        """Pooled request with the desync discipline: any OSError
        (timeout included) means unread reply bytes may still be in
        flight on that socket — a later request would read them as its
        OWN replies (silent cross-command corruption), so the
        connection is dropped before the error surfaces."""
        try:
            return self._conn(addr).request(cmds)
        except OSError:
            self._drop_conn(addr)
            raise

    # -- routing -----------------------------------------------------------

    def _route_addr(self, cmd) -> tuple:
        """(slot_or_None, addr) for one command; raises CrossSlotError
        client-side (the server would refuse it anyway)."""
        keys = command_keys(cmd)
        if not keys:
            return None, self._any_addr()
        slot = key_slot(keys[0])
        for k in keys[1:]:
            if key_slot(k) != slot:
                raise CrossSlotError(
                    "keys in this command hash to different slots; use a "
                    "{hash-tag} to co-locate them"
                )
        addr = self.slot_addr(slot)
        if addr is None:
            self.refresh_slots()
            addr = self.slot_addr(slot)
            if addr is None:
                raise ClusterDownError(f"slot {slot} not served")
        return slot, addr

    def _any_addr(self):
        with self._table_lock:
            for a in self._slots:
                if a is not None:
                    return a
        return self._seeds[0]

    @staticmethod
    def _norm(cmd) -> list:
        return [
            a if isinstance(a, bytes) else str(a).encode() for a in cmd
        ]

    # -- single-command execution ------------------------------------------

    def execute(self, *cmd):
        """Route + execute one command; follows MOVED (one table refresh
        + one retry), ASK (ASKING handshake, no table update) and
        TRYAGAIN (bounded backoff).  Non-redirect error replies raise
        ReplyError.

        A DEAD node (connect refused / socket error / unserved slot) is
        retried with backoff + a slot-table refresh from the surviving
        nodes — the redirect chase through an automatic failover: the
        retries span the detection + election window, and the refresh
        picks up the promoted replica once the takeover broadcast
        lands.  At-least-once during that window (the reply for an
        applied write can die with the node), exactly like a restarted
        redis-cluster client."""
        cmd = self._norm(cmd)
        attempt = 0
        while True:
            try:
                return self._execute_routed(cmd)
            except (OSError, ClusterDownError):
                attempt += 1
                if attempt > self._deadnode_attempts:
                    raise
                self.stats["deadnode_retries"] += 1
                time.sleep(self._deadnode_backoff_s * attempt)
                try:
                    self.refresh_slots()
                except ClusterDownError:
                    pass  # everyone unreachable right now: keep trying

    def _execute_routed(self, cmd):
        """One route + execute + redirect-chase pass (the pre-
        execute body); raises OSError/ClusterDownError on a dead node
        for execute()'s retry loop."""
        _, addr = self._route_addr(cmd)
        span = None
        if self.tracer is not None and _trace.ENABLED:
            span = self.tracer.maybe_start(
                "client:" + cmd[0].decode("latin-1", "replace").upper()
            )
        try:
            if span is not None:
                span.annotate("node", "%s:%d" % addr)
                reply = self._request(
                    addr,
                    [[b"RTPU.TRACE"] + span.ctx().wire_args(), cmd],
                )[1]
            else:
                reply = self._request(addr, [cmd])[0]
            if span is not None and isinstance(reply, ReplyError) and \
                    reply.code in ("MOVED", "ASK", "TRYAGAIN"):
                # A redirect is routing, not failure: the chase below
                # retries (untraced on the retried hop — a known span
                # gap, annotated so the trace explains itself instead
                # of showing a failed command the caller saw succeed).
                span.annotate("redirected", reply.code)
            reply = self._chase(cmd, reply, moved_budget=1)
        except BaseException:
            if span is not None:
                span.end(error=True)
            raise
        if span is not None:
            span.end(error=isinstance(reply, ReplyError))
        if isinstance(reply, ReplyError):
            raise reply
        return reply

    def _chase(self, cmd, reply, moved_budget: int,
               refresh: bool = True):
        """Follow redirects for one command's reply; returns the final
        decoded reply (ReplyError for non-redirect errors).
        ``refresh=False`` skips the table refresh on MOVED (scatter
        batches refresh ONCE for the whole batch, not per reply)."""
        tryagain = 0
        while isinstance(reply, ReplyError):
            code = reply.code
            if code == "MOVED":
                if moved_budget <= 0:
                    return reply
                moved_budget -= 1
                self.stats["moved"] += 1
                if self.obs is not None:
                    self.obs.cluster_redirects.inc(("client_moved",))
                # Ownership moved durably: refresh the WHOLE table (the
                # handoff that moved this slot usually moved a range),
                # but retry at the ADDRESS THE REDIRECT NAMED — during
                # a finalize the refresh may answer from a node the
                # coordinator has not notified yet, while the redirect
                # always names the authoritative new owner.
                _, slot, addr = _parse_redirect(str(reply))
                if refresh:
                    self.refresh_slots()
                with self._table_lock:
                    self._slots[slot] = addr
                reply = self._request(addr, [cmd])[0]
            elif code == "ASK":
                self.stats["ask"] += 1
                if self.obs is not None:
                    self.obs.cluster_redirects.inc(("client_ask",))
                _, _, addr = _parse_redirect(str(reply))
                # One-shot exception: ASKING + the command, table
                # untouched (the slot still belongs to the source until
                # SETSLOT NODE finalizes).
                replies = self._request(addr, [[b"ASKING"], cmd])
                reply = replies[1]
                if isinstance(reply, ReplyError) and reply.code == "ASK":
                    return reply  # target bounced us too: give up
            elif code == "TRYAGAIN":
                tryagain += 1
                if tryagain > self._tryagain_attempts:
                    return reply
                self.stats["tryagain"] += 1
                time.sleep(self._tryagain_backoff_s * tryagain)
                _, addr = self._route_addr(cmd)
                reply = self._request(addr, [cmd])[0]
            else:
                return reply
        return reply

    # -- pipelined multi-slot scatter/gather --------------------------------

    def execute_many(self, cmds) -> list:
        """Execute a batch: split by node, fan the per-node pipelined
        legs out concurrently, demux replies into submission order.
        Per-command redirects (a migration mid-batch) are chased
        individually after the gather.  Error replies come back as
        ReplyError INSTANCES in their slots (never raised) so one bad
        command cannot disorder the batch."""
        cmds = [self._norm(c) for c in cmds]
        by_addr: dict = {}  # addr -> [(orig_index, cmd)]
        for i, cmd in enumerate(cmds):
            _, addr = self._route_addr(cmd)
            by_addr.setdefault(addr, []).append((i, cmd))
        root = None
        if self.tracer is not None and _trace.ENABLED:
            # Head sampling for the whole batch: ONE decision covers
            # every leg, so a sampled scatter/gather yields one trace
            # spanning client legs + every node's serving spans.
            # Minted AFTER routing: a CrossSlotError above aborts the
            # batch before anything executes, and a root begun earlier
            # would be stranded un-ended (the RT011 class).
            root = self.tracer.maybe_start("client:execute_many")
        results: list = [None] * len(cmds)
        errors: list = []

        def leg(addr, entries):
            wire = [c for _, c in entries]
            lspan = None
            if root is not None:
                lspan = self.tracer.start_child(
                    root, "leg:%s:%d" % tuple(addr)
                )
                lspan.annotate("cmds", len(entries))
                # Wire prelude ahead of the pipelined leg: the leg's
                # FIRST command joins the trace on that node (one-shot,
                # the ASKING shape).  A plain server errors on the
                # prelude — harmless, the leg's replies follow.
                wire = (
                    [[b"RTPU.TRACE"] + lspan.ctx().wire_args()] + wire
                )
            try:
                replies = self._request(addr, wire)
            except (OSError, ClusterError) as e:
                if lspan is not None:
                    lspan.end(error=True)
                errors.append(e)
                return
            if lspan is not None:
                replies = replies[1:]  # drop the prelude's ack/error
                lspan.end()
            for (i, _), r in zip(entries, replies):
                results[i] = r

        self.stats["scatter_batches"] += 1
        self.stats["scatter_legs"] += len(by_addr)
        if self.obs is not None:
            self.obs.cluster_scatter_fanout.inc(("batches",))
            self.obs.cluster_scatter_fanout.inc(("legs",), len(by_addr))
        try:
            if len(by_addr) == 1:
                ((addr, entries),) = by_addr.items()
                leg(addr, entries)
            else:
                # Persistent leg pool, largest leg inline on the calling
                # thread: a thread SPAWN per leg per batch costs more
                # than a small leg's whole round trip and inverted the
                # scaling win at modest batch sizes (measured on
                # config9).
                items = sorted(
                    by_addr.items(), key=lambda kv: -len(kv[1])
                )
                futs = [
                    self._executor().submit(leg, addr, entries)
                    for addr, entries in items[1:]
                ]
                leg(*items[0])
                for f in futs:
                    f.result()
        finally:
            if root is not None:
                root.annotate("legs", len(by_addr))
                root.annotate("cmds", len(cmds))
                root.end(error=bool(errors))
        if errors:
            raise ClusterError(
                f"{len(errors)} scatter leg(s) failed: {errors[0]}"
            )
        # Chase stragglers' redirects one by one, preserving order.
        # ONE table refresh covers the whole batch (a range handoff
        # MOVEDs dozens of replies at once — per-reply refreshes would
        # hammer CLUSTER SLOTS at the busiest moment); each chase then
        # retries at its redirect's named address.
        if any(
            isinstance(r, ReplyError) and r.code == "MOVED"
            for r in results
        ):
            self.refresh_slots()
        for i, r in enumerate(results):
            if isinstance(r, ReplyError) and r.code in (
                "MOVED", "ASK", "TRYAGAIN"
            ):
                results[i] = self._chase(
                    cmds[i], r, moved_budget=1, refresh=False
                )
        return results

    # -- fleet telemetry: cross-node INFO/SLOWLOG/TRACE ---------

    def _fanout(self, cmd) -> dict:
        """{addr: decoded reply | Exception} for one command sent to
        every known data node (the slot table's node set; seeds when the
        table is empty) — the cluster-wide observability primitive.
        Nodes are queried CONCURRENTLY on the scatter-leg pool: one
        dead node costs its own timeout, not timeout × fleet (the same
        rationale as FederatedMetrics.render)."""
        with self._table_lock:
            addrs = sorted({a for a in self._slots if a is not None})
        if not addrs:
            addrs = list(self._seeds)
        out: dict = {}

        def one(addr):
            try:
                out[addr] = self._request(addr, [cmd])[0]
            except (OSError, ClusterError) as e:
                out[addr] = e

        if len(addrs) == 1:
            one(addrs[0])
            return out
        futs = [
            self._executor().submit(one, addr) for addr in addrs[1:]
        ]
        one(addrs[0])
        for f in futs:
            f.result()
        return out

    def _fanout_degraded(self, cmd) -> tuple:
        """The uniform dead-member degradation contract: fan ``cmd`` out
        and split the replies — ``(rows, errors, down_nodes)`` where
        ``rows`` is ``[(node_label, reply)]`` for reachable members,
        ``errors`` maps node label to ``{"error": str}`` (the per-node
        error row every fleet view surfaces), and ``down_nodes`` is
        the sorted dead-member list.  A member dying mid-scrape
        DEGRADES the merge — partial results plus an explicit error
        row — it never raises the whole fleet view away."""
        rows: list = []
        errors: dict = {}
        down: list = []
        for addr, raw in self._fanout(cmd).items():
            node = "%s:%d" % tuple(addr)
            if isinstance(raw, (ReplyError, Exception)):
                errors[node] = {"error": str(raw)}
                down.append(node)
                continue
            rows.append((node, raw))
        return rows, errors, sorted(down)

    # INFO keys whose fleet-wide SUM is meaningful (counters and
    # occupancy).  Everything else (ports, uptimes, rates, thresholds,
    # version strings that happen to parse numeric) stays per-node only
    # — summing a threshold across nodes is a lie, not a total.
    _ADDITIVE_INFO_PREFIXES = (
        "total_",
        "frontdoor_fused", "frontdoor_response_cache_hits",
        "frontdoor_response_cache_misses", "frontdoor_reactor_ticks",
        "frontdoor_cross_conn", "overload_shed",
        "overload_deadline_exceeded", "overload_ingress",
        "overload_tenant_throttled", "overload_fetch_timeouts",
        "overload_slow_client", "cluster_slot_migrations",
        "nearcache_hits", "nearcache_misses", "nearcache_evictions",
        "nearcache_bytes", "nearcache_entries",
    )
    _ADDITIVE_INFO_KEYS = frozenset((
        "connected_clients", "rejected_connections", "used_memory",
        "degraded_objects", "breakers_open", "monitors", "slowlog_len",
        "trace_spans", "trace_traces", "trace_sampled_total",
        "trace_evicted_total", "latency_events", "latency_samples",
        "aof_records_written", "aof_bytes_written", "aof_fsyncs",
        "aof_pending_records", "aof_replayed_records", "aof_segments",
        # Load-attribution totals — counters/occupancy only;
        # loadmap_enabled and loadmap_key_sample_rate stay per-node
        # (summing a rate across nodes is a lie, not a total).
        "loadmap_ops", "loadmap_reads", "loadmap_writes",
        "loadmap_bytes_in", "loadmap_bytes_out", "loadmap_shed_ops",
        "loadmap_device_us", "loadmap_keys", "loadmap_sampled_keys",
        "loadmap_tracked_keys",
    ))

    @classmethod
    def _info_additive(cls, key: str) -> bool:
        return key in cls._ADDITIVE_INFO_KEYS or key.startswith(
            cls._ADDITIVE_INFO_PREFIXES
        )

    def fleet_info(self, section=None) -> dict:
        """Fleet-aggregated INFO: ``{"nodes": {node: {k: v}},
        "totals": {k: sum}}`` — ADDITIVE numeric lines (counters,
        occupancy — see _info_additive) sum across nodes (the
        aggregated-telemetry view regression detection reads); raw
        per-node sections stay available for drill-down."""
        cmd = [b"INFO"] + ([section.encode()] if section else [])
        totals: dict = {}
        rows, errors, down = self._fanout_degraded(cmd)
        per_node: dict = dict(errors)
        for node, raw in rows:
            parsed: dict = {}
            for line in raw.decode("latin-1", "replace").splitlines():
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                k, v = line.split(":", 1)
                parsed[k] = v
                if not self._info_additive(k):
                    continue
                try:
                    fv = float(v)
                except ValueError:
                    continue
                totals[k] = totals.get(k, 0.0) + fv
            per_node[node] = parsed
        totals = {
            k: int(v) if float(v).is_integer() else v
            for k, v in totals.items()
        }
        return {"nodes": per_node, "totals": totals,
                "down_nodes": down}

    def fleet_slowlog(self, count: int = 10) -> list:
        """Cross-node SLOWLOG GET merge: every node's entries tagged
        with their node label, merged newest-first; ``count < 0`` = all
        (per node AND merged, like SLOWLOG GET -1).  Dead members
        degrade to trailing ``{"node", "error"}`` rows (after the
        count cut, so they always survive it)."""
        merged: list = []
        rows, errors, _down = self._fanout_degraded(
            [b"SLOWLOG", b"GET", b"%d" % count]
        )
        for node, raw in rows:
            for e in raw:
                entry = {
                    "node": node,
                    "id": int(e[0]),
                    "ts": int(e[1]),
                    "duration_us": int(e[2]),
                    "args": list(e[3]),
                    "client": e[4].decode("latin-1", "replace"),
                }
                if len(e) > 6 and e[6]:
                    entry["trace_id"] = e[6].decode(
                        "latin-1", "replace"
                    )
                merged.append(entry)
        merged.sort(
            key=lambda d: (d["ts"], d["duration_us"]), reverse=True
        )
        if count >= 0:
            merged = merged[:count]
        return merged + [
            {"node": n, **row} for n, row in sorted(errors.items())
        ]

    def fleet_traces(self, trace_id=None) -> dict:
        """{trace_id: [span dicts]} merged across every node's TRACE
        GET ring PLUS this client's own tracer — the one end-to-end view
        of a scatter/gather: client root + leg spans, each node's
        ingress/door spans, and the per-launch coalescer phases, parent
        links intact across the wire.

        Dead members degrade to the reserved ``"down_nodes"`` key
        (node label -> error row) — present only when a member was
        unreachable, so trace-id iteration stays clean on a healthy
        fleet."""
        import json as _json

        out: dict = {}
        if self.tracer is not None:
            for tid, spans in self.tracer.traces(trace_id).items():
                out.setdefault(tid, []).extend(spans)
        cmd = [b"TRACE", b"GET"] + (
            [trace_id.encode()] if trace_id else []
        )
        rows, errors, _down = self._fanout_degraded(cmd)
        for _node, raw in rows:
            for doc in raw:
                d = _json.loads(doc)
                out.setdefault(d["trace_id"], []).extend(d["spans"])
        if errors:
            out["down_nodes"] = errors
        return out

    def fleet_latency(self) -> list:
        """Cross-node LATENCY LATEST merge: one row per (node, event),
        node-tagged, worst latest-ms first — the fleet-wide view of the
        latency monitor (arm it with CONFIG SET
        latency-monitor-threshold on every node).  Dead members
        degrade to trailing ``{"node", "error"}`` rows."""
        merged: list = []
        rows, errors, _down = self._fanout_degraded(
            [b"LATENCY", b"LATEST"]
        )
        for node, raw in rows:
            for e in raw:
                merged.append({
                    "node": node,
                    "event": e[0].decode("latin-1", "replace"),
                    "ts": int(e[1]),
                    "latest_ms": int(e[2]),
                    "max_ms": int(e[3]),
                })
        merged.sort(
            key=lambda d: (d["latest_ms"], d["max_ms"]), reverse=True
        )
        return merged + [
            {"node": n, **row} for n, row in sorted(errors.items())
        ]

    def fleet_loadmap(self, hot_keys: int = 16) -> dict:
        """The fleet load map: every node's CLUSTER LOADMAP snapshot
        merged into ``{"slots": {slot: {"node", "load vector…"}},
        "top_slots": […], "hot_keys": […], "tenants": {…},
        "nodes": {node: totals}}``.

        Slots are node-disjoint (each slot is served by its owner), so
        the merge keeps the reporting node as the slot's owner tag and
        ranks slots by ops.  Hot keys merge by summed decayed estimate
        across nodes; tenant device-time shares re-normalize over the
        fleet-wide device_us total."""
        import json as _json

        slots: dict = {}
        key_heat: dict = {}
        tenants: dict = {}
        # Dead members degrade to error rows + down_nodes (the
        # federation `rtpu_federation_node_up 0` discipline, now the
        # shared _fanout_degraded contract): their last-known slots
        # simply don't refresh, and the assigner sees exactly which
        # node went dark instead of the whole fleet view raising away.
        rows, errors, down_nodes = self._fanout_degraded(
            [b"CLUSTER", b"LOADMAP"]
        )
        nodes: dict = dict(errors)
        for node, raw in rows:
            snap = _json.loads(raw)
            fields = snap["fields"]
            nodes[node] = snap.get("totals", {})
            for s, vec in snap["slots"].items():
                row = dict(zip(fields, vec))
                row["node"] = node
                prev = slots.get(int(s))
                if prev is None or row["ops"] >= prev["ops"]:
                    # A slot mid-migration can appear on two nodes;
                    # the busier report wins the owner tag.
                    slots[int(s)] = row
            for k, c in snap.get("hot_keys", []):
                key_heat[k] = key_heat.get(k, 0.0) + c
            for t, d in snap.get("tenants", {}).items():
                agg = tenants.setdefault(
                    t, {"device_us": 0.0, "ops": 0}
                )
                agg["device_us"] += d.get("device_us", 0.0)
                agg["ops"] += d.get("ops", 0)
        total_us = sum(d["device_us"] for d in tenants.values())
        for d in tenants.values():
            d["share"] = (
                round(d["device_us"] / total_us, 4) if total_us else 0.0
            )
        top_slots = sorted(
            slots, key=lambda s: slots[s]["ops"], reverse=True
        )
        hot = sorted(
            key_heat.items(), key=lambda kv: kv[1], reverse=True
        )[:hot_keys]
        return {
            "slots": slots,
            "top_slots": top_slots,
            "hot_keys": [
                {"key": k, "est": round(c, 2)} for k, c in hot
            ],
            "tenants": tenants,
            "nodes": nodes,
            "down_nodes": sorted(down_nodes),
        }

    def fleet_events(self, count: int = 0, kind: str = "") -> dict:
        """The fleet flight recorder: every node's EVENTS
        GET ring merged into ONE causally-ordered timeline —
        ``{"events": [...], "gaps": {node_id: evicted},
        "nodes": {label: ring stats | error row},
        "down_nodes": [...]}``.

        Events order by ``(wall, node, seq)`` (wall clocks across
        nodes, per-node seq proving intra-node order); a node whose
        seq stream has holes lost events to ring eviction and shows up
        in ``gaps`` with the inferred count — the record says where it
        is incomplete instead of pretending.  ``count``/``kind``
        forward to EVENTS GET (newest-N per node / kind filter, a
        trailing dot selecting a whole plane, e.g. ``"failover."``).
        Node-disjoint merge on the _fanout_degraded contract: a dead
        member contributes an error row, never an exception."""
        import json as _json

        from redisson_tpu_torch.obs.events import merge_timelines

        cmd = [b"EVENTS", b"GET"]
        if count or kind:
            cmd.append(b"%d" % count)
        if kind:
            cmd.append(kind.encode())
        per_node: dict = {}
        rows, errors, down = self._fanout_degraded(cmd)
        nodes: dict = dict(errors)
        for node, raw in rows:
            doc = _json.loads(raw)
            label = doc.get("node") or node
            nodes[node] = {
                k: doc[k]
                for k in ("seq", "evicted", "max_events")
                if k in doc
            }
            per_node.setdefault(label, []).extend(doc["events"])
        merged, gaps = merge_timelines(per_node)
        return {
            "events": merged,
            "gaps": gaps,
            "nodes": nodes,
            "down_nodes": down,
        }

    def rebalance_status(self) -> dict:
        """Every node's CLUSTER REBALANCE STATUS, node-tagged —
        unreachable members report ``{"error": …}`` (degrade, never
        raise: same discipline as fleet_loadmap)."""
        import json as _json

        out: dict = {}
        fan = self._fanout([b"CLUSTER", b"REBALANCE", b"STATUS"])
        for addr, raw in fan.items():
            node = "%s:%d" % tuple(addr)
            if isinstance(raw, (ReplyError, Exception)):
                out[node] = {"error": str(raw)}
                continue
            out[node] = _json.loads(raw)
        return out

    def doctor_status(self) -> dict:
        """Every node's CLUSTER DOCTOR STATUS, node-tagged — the
        rebalance_status shape (error rows for dead members; armed
        nodes report their finding ledger + coordinator view)."""
        import json as _json

        out: dict = {}
        rows, errors, _down = self._fanout_degraded(
            [b"CLUSTER", b"DOCTOR", b"STATUS"]
        )
        out.update(errors)
        for node, raw in rows:
            out[node] = _json.loads(raw)
        return out

    def rebalance_pause(self) -> int:
        """PAUSE every armed node's rebalancer; returns how many
        acked (pausing everywhere is what makes an assigner-off bench
        pass honest — a surviving coordinator would keep migrating)."""
        acked = 0
        fan = self._fanout([b"CLUSTER", b"REBALANCE", b"PAUSE"])
        for raw in fan.values():
            if not isinstance(raw, (ReplyError, Exception)):
                acked += 1
        return acked

    def rebalance_resume(self) -> int:
        """RESUME every armed node's rebalancer; returns acks."""
        acked = 0
        fan = self._fanout([b"CLUSTER", b"REBALANCE", b"RESUME"])
        for raw in fan.values():
            if not isinstance(raw, (ReplyError, Exception)):
                acked += 1
        return acked

    def _executor(self):
        """Shared scatter-leg thread pool (threads spawn on demand and
        idle between batches)."""
        with self._table_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=32,
                    thread_name_prefix="rtpu-cluster-leg",
                )
            return self._pool

    def close(self) -> None:
        with self._table_lock:
            conns, self._conns = list(self._conns.values()), {}
            pool, self._pool = self._pool, None
        for c in conns:
            c.close()
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
