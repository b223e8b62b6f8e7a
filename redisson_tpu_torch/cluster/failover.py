"""Automatic failover: failure detection over the cluster bus +
Redis-cluster-style epoch elections + takeover broadcast.

Split exactly along the testability seam:

- :class:`FailoverState` is PURE coordination logic — no sockets, no
  threads, no wall clock (every time-dependent method takes an explicit
  ``now``).  The JAX package's netsim failover model drives its twin
  directly, and the port's differential test feeds both the same
  seeded steps.
- :class:`FailoverAgent` is the I/O shell: a daemon thread that pings
  peers (``RTPU.CLUSTERPING``), feeds timeouts into the state, and when
  its own primary dies runs the election (``RTPU.FAILOVER.AUTH`` vote
  collection) and the takeover (promote + ``RTPU.TAKEOVER`` broadcast).

Election rules (the Redis cluster failover-auth shape, no full Raft):

- Epochs are cluster-wide and monotonic; a candidate bumps
  ``currentEpoch`` to start an election.
- Only PRIMARIES vote.  A primary grants at most ONE vote per epoch
  (``last_vote_epoch`` — recorded BEFORE the grant is visible, or two
  candidates could win one epoch), and only to a replica of a primary IT
  ALSO sees as failed.
- Majority is over ALL primaries (dead ones count in the denominator):
  ``len(primaries) // 2 + 1``.  A partitioned minority side can
  therefore never assemble a quorum — the no-dual-primary invariant.
- The winner promotes locally, stamps the failed primary's slots with
  its election epoch (:meth:`SlotMap.apply_takeover` — epoch-gated so
  a stale broadcast can never undo a newer assignment), and broadcasts
  the takeover to every reachable node.

Candidates rank themselves by replication offset: a staler replica
delays its election start proportionally to how many sibling replicas
are MORE caught up, so the best copy usually wins without any extra
round (and an acked-write-holding replica beats one that missed the
tail).  A cluster needs at least three primaries for an automatic
failover: with two, the dead one's vote is missing from a majority of
two.

The port's copy of ``redisson_tpu/cluster/failover.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange


class FailoverState:
    """Pure failure-detection + election state for one node.

    Thread-safe (RESP vote handlers and the agent tick race on it) but
    otherwise side-effect free: the only collaborator is the slotmap,
    queried for roles/replica topology."""

    def __init__(self, myid: str, slotmap, node_timeout: float = 1.5):
        self.myid = myid
        self.slotmap = slotmap
        self.node_timeout = float(node_timeout)
        self._lock = _witness.named(threading.Lock(), "failover.state")
        self.current_epoch = 0
        # Highest epoch this node VOTED in — one vote per epoch, ever.
        self.last_vote_epoch = 0
        self.last_pong: dict = {}  # node_id -> last-seen `now`
        self.failed: set = set()

    # -- liveness ----------------------------------------------------------

    def note_pong(self, node_id: str, now: float) -> None:
        with self._lock:
            self.last_pong[node_id] = now
            self.failed.discard(node_id)

    def note_ping(self, sender_id: str, epoch: int,
                  now: Optional[float] = None) -> int:
        """Receiving side of CLUSTERPING: learn the sender's epoch
        (epochs are cluster-wide maxima) and its liveness; returns this
        node's current epoch for the PONG."""
        with self._lock:
            self.current_epoch = max(self.current_epoch, int(epoch))
            if now is not None and sender_id:
                self.last_pong[sender_id] = now
                self.failed.discard(sender_id)
            return self.current_epoch

    def mark_failed(self, node_id: str) -> None:
        with self._lock:
            self.failed.add(node_id)

    def mark_alive(self, node_id: str) -> None:
        with self._lock:
            self.failed.discard(node_id)

    def is_failed(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self.failed

    def check_timeouts(self, now: float) -> list:
        """Mark every peer not heard from within node_timeout as
        failed; returns the NEWLY failed ids.  A peer never heard from
        at all gets its grace period from this first observation."""
        newly = []
        with self._lock:
            for nid in self.slotmap.node_ids():
                if nid == self.myid:
                    continue
                last = self.last_pong.setdefault(nid, now)
                if (now - last > self.node_timeout
                        and nid not in self.failed):
                    self.failed.add(nid)
                    newly.append(nid)
        return newly

    # -- election ----------------------------------------------------------

    def majority(self) -> int:
        """Quorum over ALL primaries — unreachable ones count in the
        denominator, so a minority partition can never elect."""
        return len(self.slotmap.primary_ids()) // 2 + 1

    def start_election(self) -> int:
        """Candidate side: bump currentEpoch and run under it."""
        with self._lock:
            self.current_epoch += 1
            return self.current_epoch

    def grant_vote(self, candidate_id: str, epoch: int,
                   failed_primary_id: str) -> bool:
        """Voter (primary) side: grant iff the epoch is newer than any
        this node voted in, the candidate replicates the primary in
        question, and THIS node also sees that primary as failed."""
        epoch = int(epoch)
        with self._lock:
            if epoch <= self.last_vote_epoch:
                return False  # one vote per epoch — ever
            if failed_primary_id not in self.failed:
                return False  # we still see it alive: no deposing
            if self.slotmap.replica_of(candidate_id) != failed_primary_id:
                return False  # only its own replicas may succeed it
            # Record the vote BEFORE it becomes visible: without it two
            # candidates could each win the same epoch (dual primary).
            self.last_vote_epoch = epoch
            self.current_epoch = max(self.current_epoch, epoch)
            return True

    def note_takeover(self, new_id: str, old_id: str, epoch: int) -> None:
        with self._lock:
            self.current_epoch = max(self.current_epoch, int(epoch))
            self.failed.discard(new_id)


class FailoverAgent(threading.Thread):
    """The cluster-bus I/O shell around :class:`FailoverState`.

    Pings every peer each interval over short-lived connections
    (``wireutil.exchange``), feeds timeouts into the state, and when
    this node is a replica whose primary died: offset-ranked delay →
    election → promote + takeover broadcast."""

    def __init__(self, server, node_timeout_s: float = 1.5,
                 ping_interval_s: float = 0.3,
                 election_rank_delay_s: float = 0.1):
        super().__init__(name="rtpu-failover", daemon=True)
        if server.cluster is None:
            raise ValueError("failover agent requires cluster mode")
        self.server = server
        self.myid = server.cluster.myid
        self.slotmap = server.cluster.slotmap
        self.state = FailoverState(
            self.myid, self.slotmap, node_timeout=node_timeout_s
        )
        self.ping_interval_s = float(ping_interval_s)
        self.election_rank_delay_s = float(election_rank_delay_s)
        self.obs = server.obs
        self.elections = 0
        self.takeovers = 0
        # Peer replication offsets learned from PONGs — the election
        # self-ranking input (best-copy-first without an extra round).
        self.peer_offsets: dict = {}
        # Standing-election pacing: a lost election (voters may detect
        # the death a tick later than this replica) retries every
        # node_timeout until the takeover moves the dead node's slots.
        self._next_election_t = 0.0
        self._stop_evt = threading.Event()
        server.failover = self

    def _events(self):
        """The flight-recorder ring, or None pre-obs (tests build bare
        agents); every emit point in this agent rides this accessor."""
        return getattr(self.obs, "events", None)

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=join_timeout_s)

    # -- bus I/O -----------------------------------------------------------

    def _call(self, node_id: str, *cmd):
        """One request on a short-lived connection; None on any network
        failure (failure detection happens via timeouts, not here)."""
        addr = self.slotmap.addr(node_id)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(addr, timeout=1.0)
        except OSError:
            return None
        try:
            sock.settimeout(2.0)
            (reply,) = exchange(sock, [cmd])
            return reply
        except OSError:
            return None
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self._tick()
            except Exception:  # pragma: no cover — the bus must not die
                pass
            self._stop_evt.wait(self.ping_interval_s)

    def _tick(self) -> None:
        now = time.monotonic()
        for nid in self.slotmap.node_ids():
            if nid == self.myid or self._stop_evt.is_set():
                continue
            reply = self._call(
                nid, "RTPU.CLUSTERPING", self.myid,
                str(self.state.current_epoch),
            )
            if (isinstance(reply, list) and len(reply) >= 4
                    and not isinstance(reply, ReplyError)):
                self.state.note_pong(nid, time.monotonic())
                try:
                    self.state.note_ping("", int(reply[2]))
                    self.peer_offsets[nid] = int(reply[3])
                except (TypeError, ValueError):
                    pass
        newly_failed = self.state.check_timeouts(time.monotonic())
        events = self._events()
        if events is not None:
            for nid in newly_failed:
                events.emit("failover.detected", severity="warn",
                            peer=nid, timeout_s=self.state.node_timeout)
        # Standing check, NOT an edge trigger on newly-failed: a lost
        # election (voters detect the death a tick later than we do, or
        # a vote round races another candidate) must retry until the
        # takeover actually moves the slots off the dead primary.
        my_primary = self.slotmap.replica_of(self.myid)
        if (my_primary is None or self.server.replica_link is None
                or not self.state.is_failed(my_primary)
                or not self.slotmap.ranges(my_primary)):
            return
        now = time.monotonic()
        if now < self._next_election_t:
            return
        self._next_election_t = now + self.state.node_timeout
        self._try_failover(my_primary)

    # -- election + takeover ----------------------------------------------

    def _try_failover(self, failed_primary: str) -> None:
        # Offset rank: delay per sibling replica MORE caught up than
        # this node, so the best copy usually starts (and wins) first.
        link = self.server.replica_link
        my_offset = int(link.applied) if link is not None else 0
        siblings = [
            rid for rid in self.slotmap.replicas_of(failed_primary)
            if rid != self.myid
        ]
        ahead = sum(
            1 for rid in siblings
            if self.peer_offsets.get(rid, -1) > my_offset
        )
        delay = ahead * self.election_rank_delay_s
        if delay and self._stop_evt.wait(delay):
            return
        # Re-check: a better-ranked sibling may have taken over during
        # the delay (its broadcast moved the slots off the dead node).
        if not self.slotmap.ranges(failed_primary):
            return
        if not self.state.is_failed(failed_primary):
            return  # it came back — no deposing a live primary
        election_t0 = time.monotonic()
        epoch = self.state.start_election()
        self.elections += 1
        if self.obs is not None:
            try:
                self.obs.failover_elections.inc((), 1)
            except AttributeError:
                pass
        votes = 0
        for pid in self.slotmap.primary_ids():
            if pid == failed_primary:
                continue  # it is dead; it still counts in the quorum
            reply = self._call(
                pid, "RTPU.FAILOVER.AUTH", self.myid, str(epoch),
                failed_primary,
            )
            if isinstance(reply, int) and reply == 1:
                votes += 1
        events = self._events()
        if votes < self.state.majority():
            if events is not None:
                events.emit("failover.election.lost", severity="warn",
                            epoch=epoch, votes=votes,
                            needed=self.state.majority(),
                            failed_primary=failed_primary)
            self._record_election_ms(election_t0)
            return  # lost (or partitioned into a minority): stand down
        if events is not None:
            events.emit("failover.election.won", epoch=epoch,
                        votes=votes, needed=self.state.majority(),
                        failed_primary=failed_primary)
        self._takeover(failed_primary, epoch)
        self._record_election_ms(election_t0)

    def _record_election_ms(self, t0: float) -> None:
        """Feed the LATENCY 'election' event (unavailability window:
        election start through win/loss, takeover included)."""
        if self.obs is not None:
            try:
                self.obs.latency.record(
                    "election", (time.monotonic() - t0) * 1e3)
            except AttributeError:
                pass

    def _takeover(self, failed_primary: str, epoch: int) -> None:
        """Won the election: promote locally, claim the slots, tell
        everyone.  Local promotion FIRST — a node that crashes between
        promote and broadcast is simply a primary nobody routes to
        until the next election re-runs."""
        # Snapshot the claim BEFORE applying: the broadcast carries the
        # explicit ranges so receivers resolve purely by epoch (see
        # SlotMap.apply_takeover — delivery-order-independent).
        claim = self.slotmap.ranges(failed_primary)
        spec = ",".join(f"{a}-{b}" for a, b in claim)
        self.server.promote_to_primary(epoch)
        self.slotmap.apply_takeover(failed_primary, self.myid, epoch)
        self.state.note_takeover(self.myid, failed_primary, epoch)
        self.takeovers += 1
        events = self._events()
        if events is not None:
            events.emit("failover.takeover.sent", epoch=epoch,
                        slots=spec, from_node=failed_primary)
        for nid in self.slotmap.node_ids():
            if nid in (self.myid, failed_primary):
                continue
            self._call(
                nid, "RTPU.TAKEOVER", self.myid, failed_primary,
                str(epoch), spec,
            )
