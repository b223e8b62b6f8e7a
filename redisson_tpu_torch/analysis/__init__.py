"""Correctness tooling of the port.

- :mod:`redisson_tpu_torch.analysis.rtpulint` — the port's AST-based
  static analyser (stdlib ``ast`` only), rules RT000-RT015.  Run it with
  ``python -m redisson_tpu_torch.analysis`` (default path
  ``redisson_tpu_torch``); suppress a deliberate violation inline with
  ``# rtpulint: disable=RTnnn <reason>`` (the reason is mandatory).
- :mod:`redisson_tpu_torch.analysis.lockgraph` — the whole-tree static
  lock-order pass (RT010) over the witness-named locks, merged with the
  edges an armed witness exported (``--runtime-edges``).
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
# that import dragged the AST analyser (ast/tokenize/io) or the schedule
# explorer into every serving process.  The tooling loads only when
# something actually lints or explores (the CLI, tests).
_ANALYZER_EXPORTS = frozenset((
    "RULES", "StaleSuppression", "Violation", "audit_paths",
    "lint_file", "lint_paths", "lint_source",
))
_LOCKGRAPH_EXPORTS = frozenset((
    "build_graph", "find_cycles", "lint_tree", "load_runtime_edges",
    "merge_runtime_edges",
))
_EXPLORER_EXPORTS = frozenset((
    "checkpoint", "explore", "schedule_test",
))

__all__ = sorted(
    _ANALYZER_EXPORTS | _LOCKGRAPH_EXPORTS | _EXPLORER_EXPORTS
)


def __getattr__(name: str):
    if name in _ANALYZER_EXPORTS:
        from redisson_tpu_torch.analysis import rtpulint

        return getattr(rtpulint, name)
    if name in _LOCKGRAPH_EXPORTS:
        from redisson_tpu_torch.analysis import lockgraph

        return getattr(lockgraph, name)
    if name in _EXPLORER_EXPORTS:
        from redisson_tpu_torch.analysis import explorer

        return getattr(explorer, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
