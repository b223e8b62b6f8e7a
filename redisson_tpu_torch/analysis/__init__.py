"""Correctness tooling of the port.

- :mod:`redisson_tpu_torch.analysis.witness` — an opt-in
  (``RTPU_LOCK_WITNESS=1``) runtime lock-order witness: locks created
  through ``witness.named`` record the per-thread acquisition graph,
  and cycles (potential deadlock) or blocking calls made while a named
  lock is held are reported with the offending stack pairs.
- :mod:`redisson_tpu_torch.analysis.explorer` — the deterministic
  schedule explorer (CHESS-style bounded-exhaustive interleavings of
  the stdlib threading primitives, replay tokens).
- :mod:`redisson_tpu_torch.analysis.netsim` — the explorer extended
  across the process boundary: simulated sockets, message drops,
  deferrals, crashes and restarts, for the cluster protocol models.
"""

# Lazy re-exports (PEP 562): production modules import
# `analysis.witness` at module load to name their locks, and the
# witness's zero-overhead-when-disabled contract would ring hollow if
# that import dragged the schedule explorer into every serving process.
_EXPLORER_EXPORTS = frozenset((
    "checkpoint", "explore", "schedule_test",
))

__all__ = sorted(_EXPLORER_EXPORTS)


def __getattr__(name: str):
    if name in _EXPLORER_EXPORTS:
        from redisson_tpu_torch.analysis import explorer

        return getattr(explorer, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
