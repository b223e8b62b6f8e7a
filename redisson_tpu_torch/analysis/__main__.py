"""CLI: ``python -m redisson_tpu_torch.analysis [paths...]``.

Runs the per-file rules (RT001-RT009) AND — when any path is a
directory — the whole-tree static lock-order pass (RT010,
analysis/lockgraph.py): the witness-named lock graph extracted across
every call path must be acyclic, optionally merged with a runtime
witness export (``--runtime-edges``).

Exit status: 0 when every finding is suppressed (or none), 1 when any
unsuppressed violation remains, 2 on usage errors.  CI runs this over
``redisson_tpu_torch/`` in the port's workflow
(``.github/workflows/torch_port.yml``), and again with the edges an
armed witness exported from the port's suites.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from redisson_tpu_torch.analysis.rtpulint import RULES, lint_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m redisson_tpu_torch.analysis",
        description="rtpulint: project-invariant static analyzer "
                    "(rules RT000-RT015)",
    )
    ap.add_argument("paths", nargs="*", default=["redisson_tpu_torch"],
                    help="files/directories to lint "
                         "(default: redisson_tpu_torch)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="RTnnn",
                    help="run only these rules (repeatable)")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="parallel per-file analysis on N processes "
                         "(0 = cpu count; findings are byte-identical "
                         "to --jobs 1)")
    ap.add_argument("--audit-suppressions", action="store_true",
                    help="also report STALE '# rtpulint: disable=' "
                         "comments (their rule no longer fires when "
                         "removed) and exit 1 on any — dead armor "
                         "silences real future findings")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-lock-graph", action="store_true",
                    help="skip the whole-tree RT010 lock-order pass")
    ap.add_argument("--runtime-edges", metavar="FILE",
                    help="witness export (RTPU_LOCK_WITNESS_EXPORT JSON) "
                         "to merge into the static lock graph")
    ap.add_argument("--dump-lock-graph", action="store_true",
                    help="print the extracted catalog + edges as JSON and "
                         "exit (no linting)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if args.rules:
        bad = [r for r in args.rules if r not in RULES]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}", file=sys.stderr)
            return 2

    paths = args.paths or ["redisson_tpu_torch"]

    have_dir = any(os.path.isdir(p) for p in paths)
    wanted_rt010 = args.rules is not None and "RT010" in args.rules
    run_graph = (
        not args.no_lock_graph
        and (args.rules is None or wanted_rt010
             # An explicit --runtime-edges IS a request for the merge:
             # honor it even when --rule narrowed to other rules.
             or bool(args.runtime_edges))
        and have_dir
    )
    # The lock graph is a WHOLE-TREE pass: on file-only paths it cannot
    # run.  Skipping it silently when the caller asked for it by name
    # would report "gate passed" for a gate that never ran.
    if not run_graph and not args.dump_lock_graph:
        if args.runtime_edges and args.no_lock_graph:
            print(
                "warning: --runtime-edges ignored (--no-lock-graph)",
                file=sys.stderr,
            )
        elif (wanted_rt010 or args.runtime_edges) and not have_dir:
            print(
                "error: RT010/--runtime-edges need a directory path "
                "(the lock graph is a whole-tree pass; file-only paths "
                "cannot run it)",
                file=sys.stderr,
            )
            return 2

    def _load_runtime(lockgraph):
        """Usage-error (exit 2) on a missing/malformed witness export —
        realistic in CI: export_to is best-effort and only registers
        when the witness actually armed, so the file may not exist."""
        try:
            return lockgraph.load_runtime_edges(args.runtime_edges)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(
                f"error: cannot read --runtime-edges "
                f"{args.runtime_edges!r}: {e} (was the witness armed? "
                f"RTPU_LOCK_WITNESS=1 + RTPU_LOCK_WITNESS_EXPORT "
                f"produce it)",
                file=sys.stderr,
            )
            return None

    if args.dump_lock_graph:
        from redisson_tpu_torch.analysis import lockgraph

        graph = lockgraph.build_graph(paths)
        if args.runtime_edges:
            runtime = _load_runtime(lockgraph)
            if runtime is None:
                return 2
            lockgraph.merge_runtime_edges(graph, runtime)
        json.dump(graph.to_dict(), sys.stdout, indent=2)
        print()
        return 0

    file_rules = (
        [r for r in args.rules if r != "RT010"] if args.rules else None
    )
    violations = []
    if file_rules is None or file_rules:
        violations = lint_paths(paths, rules=file_rules, jobs=args.jobs)

    graph = None
    if run_graph:
        from redisson_tpu_torch.analysis import lockgraph

        runtime = None
        if args.runtime_edges:
            runtime = _load_runtime(lockgraph)
            if runtime is None:
                return 2
        graph, cycle_violations = lockgraph.lint_tree(
            paths, runtime_edges=runtime
        )
        violations.extend(cycle_violations)

    stale = []
    if args.audit_suppressions:
        from redisson_tpu_torch.analysis.rtpulint import audit_paths

        # RT010-naming comments verify against the lock graph's
        # consumed sites; without the whole-tree pass they are skipped
        # (the audit never guesses).
        rt010_sites = graph.suppressed_sites if graph is not None \
            else None
        stale = audit_paths(
            paths, jobs=args.jobs, rt010_sites=rt010_sites,
            # The all-rules pass above already holds every
            # suppressed hit — reuse it rather than linting the
            # tree a second time (only when no --rule filter
            # narrowed it).
            violations=violations if file_rules is None else None,
        )

    live = [v for v in violations if not v.suppressed]
    suppressed = [v for v in violations if v.suppressed]
    for v in live:
        print(v.format())
    for s in stale:
        print(s.format())
    if args.show_suppressed:
        for v in suppressed:
            print(v.format())
    tail = ""
    if graph is not None:
        tail = (
            f"; lock graph: {len(graph.catalog)} locks, "
            f"{len(graph.edges)} edges, "
            f"{len(graph.suppressed)} suppressed edges"
        )
    if args.audit_suppressions:
        tail += f"; suppression audit: {len(stale)} stale"
    print(
        f"rtpulint: {len(live)} violation(s), "
        f"{len(suppressed)} suppressed{tail}",
        file=sys.stderr,
    )
    return 1 if live or stale else 0


if __name__ == "__main__":
    sys.exit(main())
