"""Static lock-order graph over witness-named locks.

The runtime witness (analysis/witness.py) records the lock-acquisition
graph of schedules that RUN; a cycle it has never executed stays
invisible.  This module is the static half of the witness/lockdep
lineage: a whole-tree AST pass that

1. builds the lock CATALOG — every ``witness.named(lock, "name")``
   creation site, plus ``threading.Condition(<named lock>)`` aliases
   (a condition acquires its underlying lock);
2. extracts, per function, which catalog locks are acquired while
   which others are held (``with`` bodies and ``acquire()``/
   ``release()`` spans), and which FUNCTIONS are called under a held
   lock;
3. closes the call graph (bounded name-based resolution: ``self.m()``
   resolves inside the defining class; other calls resolve by bare
   name when at most :data:`AMBIG_CAP` tree functions share it — more
   than that is treated as too generic to mean anything) into
   lock -> lock edges with a representative call chain per edge;
4. merges witness-observed RUNTIME edges (``witness.export_edges()``
   or a JSON dump from ``RTPU_LOCK_WITNESS_EXPORT``) into the same
   name-level graph; and
5. reports every CYCLE in the merged graph as rule **RT010** — a
   potential deadlock that fails CI even if no test has ever executed
   the interleaving.

Suppression follows the rtpulint convention: an edge whose inner-
acquisition site line carries ``# rtpulint: disable=RT010 <reason>``
is a documented by-design edge and leaves the graph.  Runtime edges
have no source line and cannot be suppressed — a cycle the witness
actually observed is never arguable.

The analysis is deliberately an OVER-approximation (name-based call
resolution, all held locks edge to every transitively acquired lock):
a reported cycle may be infeasible, but an absent cycle is a real
guarantee over the modeled constructs.  Locks acquired through
non-catalog objects (``entry.pool._dispatch_lock``) are out of scope —
by design, the executor dispatch lock is not witness-named either.
"""

from __future__ import annotations

import ast
import builtins as _builtins
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from redisson_tpu_torch.analysis.rtpulint import (
    Violation,
    _scan_comments,
    _walk_no_defs,
)

# A bare call name shared by more than this many tree functions is too
# generic to resolve (``start``, ``get``, ``result``, ...): resolving
# it would spray edges through unrelated code and drown the gate in
# infeasible cycles.
AMBIG_CAP = 3

# Bare names that collide with builtin collection/str methods: a call
# ``self._degraded.discard(kind)`` is a SET op, not the LRU store's
# ``discard`` — resolving these by name manufactures edges through
# unrelated classes.  (``self.m()`` calls still resolve precisely
# inside their own class.)
GENERIC_NAMES = frozenset((
    "add", "append", "clear", "copy", "count", "decode", "discard",
    "encode", "extend", "format", "get", "index", "insert", "items",
    "join", "keys", "pop", "popitem", "put", "remove", "replace",
    "setdefault", "sort", "split", "strip", "update", "values", "wait",
    "wait_for", "notify", "notify_all", "acquire", "release", "close",
    "flush", "read", "write", "send", "recv", "start", "run", "result",
    "done", "set", "random",
    # ``x.submit(...)`` is usually a ThreadPoolExecutor, not the
    # coalescer; resolving it by bare name manufactured
    # topics-lock -> coalescer.queue edges.  Deadline threading into
    # real coalescer submits is RT007's job, not the lock graph's.
    "submit",
    # ``path.exists()`` is pathlib/os.path, not the engine's or the grid
    # store's ``exists``: resolved by name, the native codec's build
    # check manufactured serve.native_codec -> engine/grid edges.
    "exists",
)) | frozenset(dir(_builtins))

# Attr names too generic for the unique-across-tree fallback: half the
# classes in the tree own a ``self._lock``/``self._idle``; only the
# witness-NAMED one is in the catalog, so "unique among named locks"
# does not mean unique in the tree (the fallback exists for mixins
# reaching a distinctive attr like ``_mirror_lock``).
GENERIC_ATTRS = frozenset((
    "lock", "_lock", "cond", "_cond", "_idle", "_wake", "_plock",
    "_tlock", "mutex",
))

RUNTIME_SITE = "<runtime witness>"


@dataclass
class EdgeSite:
    file: str
    line: int
    chain: Tuple[str, ...] = ()  # call chain from the holder to the acquire

    def format(self) -> str:
        via = f" via {' -> '.join(self.chain)}" if self.chain else ""
        return f"{self.file}:{self.line}{via}"


@dataclass
class LockGraph:
    # name -> [(file, line)] creation sites (the catalog)
    catalog: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    # (src, dst) -> [EdgeSite]
    edges: Dict[Tuple[str, str], List[EdgeSite]] = field(default_factory=dict)
    # edges dropped by a reasoned RT010 suppression: (src, dst) -> reason
    suppressed: Dict[Tuple[str, str], str] = field(default_factory=dict)
    # (file, comment_line) of every RT010 suppression that actually
    # swallowed an edge — the stale-suppression audit's ground truth
    suppressed_sites: Set[Tuple[str, int]] = field(default_factory=set)

    def add_edge(self, src: str, dst: str, site: EdgeSite) -> None:
        if src == dst:
            return  # reentrant same-class acquisition, not an order edge
        self.edges.setdefault((src, dst), []).append(site)

    def successors(self, name: str) -> Set[str]:
        return {b for (a, b) in self.edges if a == name}

    def to_dict(self) -> dict:
        return {
            "catalog": {
                k: [f"{f}:{ln}" for f, ln in v]
                for k, v in sorted(self.catalog.items())
            },
            "edges": {
                f"{a} -> {b}": [s.format() for s in sites]
                for (a, b), sites in sorted(self.edges.items())
            },
            "suppressed_edges": {
                f"{a} -> {b}": why
                for (a, b), why in sorted(self.suppressed.items())
            },
        }


# -- AST helpers --------------------------------------------------------------


def _is_witness_named(call: ast.Call) -> Optional[str]:
    """The lock name when ``call`` is ``<witness alias>.named(x, "name")``."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr == "named"
        and isinstance(f.value, ast.Name)
        and f.value.id.lstrip("_").endswith("witness")
        and len(call.args) >= 2
        and isinstance(call.args[1], ast.Constant)
        and isinstance(call.args[1].value, str)
    ):
        return call.args[1].value
    return None


def _find_named_call(expr) -> Optional[str]:
    """witness.named anywhere inside ``expr`` (e.g. wrapped in
    ``threading.Condition(_witness.named(...))``)."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            name = _is_witness_named(n)
            if name is not None:
                return name
    return None


def _is_condition_call(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute) and f.attr == "Condition"
    ) or (isinstance(f, ast.Name) and f.id == "Condition")


def _self_attr(node) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclass
class _FuncInfo:
    key: str                 # "module:Class.name" / "module:name"
    name: str                # bare name
    cls: Optional[str]
    module: str
    file: str
    node: ast.AST
    # lock names acquired anywhere in the body (directly)
    acquires: Set[str] = field(default_factory=set)
    # (frozenset(held), lockname, line): direct nested acquisition
    nested: List[tuple] = field(default_factory=list)
    # (frozenset(held), callee bare name, is_self_call, line)
    calls_under: List[tuple] = field(default_factory=list)
    # callee names called anywhere (for transitive acquires)
    calls_all: Set[tuple] = field(default_factory=set)  # (name, is_self)


class _TreeIndex:
    def __init__(self):
        self.funcs: Dict[str, _FuncInfo] = {}
        self.by_name: Dict[str, List[str]] = {}
        self.by_self: Dict[Tuple[str, str], str] = {}  # (cls, name) -> key

    def add(self, fi: _FuncInfo) -> None:
        self.funcs[fi.key] = fi
        self.by_name.setdefault(fi.name, []).append(fi.key)
        if fi.cls is not None:
            self.by_self[(fi.cls, fi.name)] = fi.key

    def resolve(self, callee: str, is_self: bool,
                cls: Optional[str]) -> List[str]:
        if callee.startswith("__") and callee.endswith("__"):
            return []
        if is_self and cls is not None:
            k = self.by_self.get((cls, callee))
            if k is not None:
                return [k]
        if callee in GENERIC_NAMES:
            return []
        keys = self.by_name.get(callee, [])
        if 0 < len(keys) <= AMBIG_CAP:
            return keys
        return []


# -- extraction ---------------------------------------------------------------


def _iter_py(path: str):
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        # ``analysis`` is excluded: the analyzer must not model itself
        # (its helper names — wait_for, block, ... — collide with the
        # serving tree's and manufacture call chains through the tool).
        dirnames[:] = [
            d for d in dirnames
            if d not in ("__pycache__", ".git", "fixtures", "analysis")
        ]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _collect_lock_maps(tree, rel: str, graph: LockGraph):
    """(class attr map, module map).  attr map: (class, attr) -> name;
    module map: var -> name.  Also fills the catalog."""
    attr_map: Dict[Tuple[str, str], str] = {}
    mod_map: Dict[str, str] = {}

    def scan_assign(target, value, cls: Optional[str], line: int):
        name = _find_named_call(value) if isinstance(value, ast.AST) else None
        if name is None:
            return False
        graph.catalog.setdefault(name, []).append((rel, line))
        sattr = _self_attr(target)
        if sattr is not None and cls is not None:
            attr_map[(cls, sattr)] = name
        elif isinstance(target, ast.Name):
            mod_map[target.id] = name
        return True

    # First pass: direct witness.named assignments.
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    scan_assign(sub.targets[0], sub.value, node.name,
                                sub.lineno)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            # module level (not inside a class — approximated by a
            # second scan; duplicates are harmless)
            scan_assign(node.targets[0], node.value, None, node.lineno)

    # Second pass: Condition aliases of already-named locks
    # (``self._wake = threading.Condition(self._lock)``).
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.value, ast.Call)
                    and _is_condition_call(sub.value)
                    and sub.value.args):
                continue
            inner = sub.value.args[0]
            lock_name = None
            sattr = _self_attr(inner)
            if sattr is not None:
                lock_name = attr_map.get((node.name, sattr))
            elif isinstance(inner, ast.Name):
                lock_name = mod_map.get(inner.id)
            if lock_name is None:
                continue
            tattr = _self_attr(sub.targets[0])
            if tattr is not None:
                attr_map[(node.name, tattr)] = lock_name
            elif isinstance(sub.targets[0], ast.Name):
                mod_map[sub.targets[0].id] = lock_name
    return attr_map, mod_map


def _scan_function(fi: _FuncInfo, attr_map, mod_map, attr_fallback):
    """Fill acquires / nested / calls_under / calls_all by walking the
    statement tree with a held-lock stack."""

    def lock_of(expr) -> Optional[str]:
        sattr = _self_attr(expr)
        if sattr is not None:
            if fi.cls is not None and (fi.cls, sattr) in attr_map:
                return attr_map[(fi.cls, sattr)]
            return attr_fallback.get(sattr)  # unique-across-tree fallback
        if isinstance(expr, ast.Name):
            return mod_map.get(expr.id)
        return None

    def note_calls(stmt, held: tuple):
        for n in _walk_no_defs(stmt):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute):
                callee = f.attr
                is_self = _self_attr(f) is not None
            elif isinstance(f, ast.Name):
                callee = f.id
                is_self = False
            else:
                continue
            fi.calls_all.add((callee, is_self))
            if held:
                fi.calls_under.append(
                    (frozenset(held), callee, is_self, n.lineno)
                )

    def block(stmts, held: list):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                added = []
                for item in stmt.items:
                    name = lock_of(item.context_expr)
                    if name is not None:
                        fi.acquires.add(name)
                        for h in held:
                            fi.nested.append(
                                (frozenset([h]), name, stmt.lineno)
                            )
                        if name not in held:
                            held.append(name)
                            added.append(name)
                # expressions in the with items may call things
                note_calls(stmt.items[0].context_expr, tuple(
                    h for h in held if h not in added
                ))
                block(stmt.body, held)
                for name in added:
                    held.remove(name)
                continue
            # statement-level acquire()/release()
            call = None
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                call = stmt.value
            if call is not None and isinstance(call.func, ast.Attribute):
                recv_name = lock_of(call.func.value)
                if recv_name is not None:
                    if call.func.attr == "acquire":
                        fi.acquires.add(recv_name)
                        for h in held:
                            fi.nested.append(
                                (frozenset([h]), recv_name, stmt.lineno)
                            )
                        if recv_name not in held:
                            held.append(recv_name)
                        continue
                    if call.func.attr == "release":
                        if recv_name in held:
                            held.remove(recv_name)
                        continue
            note_calls(stmt, tuple(held))
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    block(sub, held)
            for handler in getattr(stmt, "handlers", ()) or ():
                block(handler.body, held)

    node = fi.node
    block(node.body, [])


def build_graph(paths: Iterable[str],
                suppressions: Optional[dict] = None) -> LockGraph:
    """Whole-tree extraction.  ``suppressions`` maps file -> (line ->
    [(rules, reason)]) as parsed by rtpulint; when omitted it is read
    from each file's comments."""
    graph = LockGraph()
    index = _TreeIndex()
    per_file: List[tuple] = []  # (rel, tree, attr_map, mod_map, source)

    files = []
    for p in paths:
        files.extend(_iter_py(p))
    sources = {}
    for fp in files:
        try:
            with open(fp, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=fp)
        except (OSError, SyntaxError):
            continue
        sources[fp] = src
        attr_map, mod_map = _collect_lock_maps(tree, fp, graph)
        per_file.append((fp, tree, attr_map, mod_map))

    # Unique-attr fallback: an attr name mapped to exactly one lock
    # name tree-wide resolves even from a mixin that did not create it.
    attr_union: Dict[str, Set[str]] = {}
    for _, _, attr_map, _ in per_file:
        for (_cls, attr), name in attr_map.items():
            attr_union.setdefault(attr, set()).add(name)
    attr_fallback = {
        attr: next(iter(names))
        for attr, names in attr_union.items()
        if len(names) == 1 and attr not in GENERIC_ATTRS
    }

    # Function inventory + per-function scan.
    for fp, tree, attr_map, mod_map in per_file:
        module = os.path.splitext(os.path.basename(fp))[0]

        def visit(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = (f"{module}:{cls}.{child.name}"
                            if cls else f"{module}:{child.name}")
                    fi = _FuncInfo(qual, child.name, cls, module, fp, child)
                    index.add(fi)
                    _scan_function(fi, attr_map, mod_map, attr_fallback)
                    visit(child, cls)  # nested defs keep the class scope

        visit(tree, None)

    # Transitive acquires: fixpoint over the bounded call graph.
    acq: Dict[str, Set[str]] = {
        k: set(fi.acquires) for k, fi in index.funcs.items()
    }
    # via[f][lock] = (callee key) that leads to the lock (chain hints)
    via: Dict[str, Dict[str, str]] = {k: {} for k in index.funcs}
    changed = True
    while changed:
        changed = False
        for k, fi in index.funcs.items():
            for callee, is_self in fi.calls_all:
                for ck in index.resolve(callee, is_self, fi.cls):
                    if ck == k:
                        continue
                    new = acq[ck] - acq[k]
                    if new:
                        acq[k] |= new
                        for lock in new:
                            via[k].setdefault(lock, ck)
                        changed = True

    def chain_to(fkey: str, lock: str, limit: int = 8) -> Tuple[str, ...]:
        chain = []
        k = fkey
        while len(chain) < limit:
            fi = index.funcs.get(k)
            if fi is None:
                break
            chain.append(fi.name)
            if lock in fi.acquires:
                break
            nxt = via.get(k, {}).get(lock)
            if nxt is None or nxt == k:
                break
            k = nxt
        return tuple(chain)

    # Edges: direct nesting + calls-under-lock closed over acquires*.
    supp_cache: Dict[str, dict] = {}

    def suppressed_reason(fp: str, line: int) -> Optional[str]:
        if suppressions is not None:
            table = suppressions.get(fp, {})
        else:
            if fp not in supp_cache:
                supp, _role, _bad = _scan_comments(sources.get(fp, ""))
                supp_cache[fp] = supp
            table = supp_cache[fp]
        for rules, reason, cline in table.get(line, ()):
            if "RT010" in rules:
                # Consumed-site record: the stale-suppression audit
                # (--audit-suppressions) verifies RT010 comments
                # against exactly this set.
                graph.suppressed_sites.add((fp, cline))
                return reason
        return None

    for k, fi in index.funcs.items():
        for held, lock, line in fi.nested:
            for h in held:
                why = suppressed_reason(fi.file, line)
                if why is not None:
                    graph.suppressed[(h, lock)] = why
                    continue
                graph.add_edge(h, lock, EdgeSite(fi.file, line))
        for held, callee, is_self, line in fi.calls_under:
            for ck in index.resolve(callee, is_self, fi.cls):
                if ck == k:
                    continue
                for lock in acq.get(ck, ()):
                    for h in held:
                        if h == lock:
                            continue
                        why = suppressed_reason(fi.file, line)
                        if why is not None:
                            graph.suppressed[(h, lock)] = why
                            continue
                        graph.add_edge(
                            h, lock,
                            EdgeSite(fi.file, line,
                                     (fi.name,) + chain_to(ck, lock)),
                        )
    return graph


# -- runtime merge ------------------------------------------------------------


def merge_runtime_edges(graph: LockGraph,
                        edges: Iterable[Tuple[str, str]]) -> int:
    """Fold witness-observed runtime edges into the static graph.
    Returns how many NEW edges (not statically derived) were added.
    Runtime edges carry no source line and cannot be suppressed."""
    added = 0
    for a, b in edges:
        if a == b:
            continue
        key = (str(a), str(b))
        if key not in graph.edges:
            added += 1
        graph.edges.setdefault(key, []).append(
            EdgeSite(RUNTIME_SITE, 0)
        )
    return added


def load_runtime_edges(path: str) -> List[Tuple[str, str]]:
    """Read a witness export (``RTPU_LOCK_WITNESS_EXPORT`` JSON or
    ``witness.export_edges()`` dumped as ``{"edges": [[a, b], ...]}``)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    edges = data["edges"] if isinstance(data, dict) else data
    return [(str(a), str(b)) for a, b in edges]


# -- cycle detection ----------------------------------------------------------


def _cyclic_sccs(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly-connected components that contain a cycle (size > 1,
    or a self-loop), via iterative Tarjan."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    nodes = sorted(set(adj) | {b for succ in adj.values() for b in succ})
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    n = stack.pop()
                    on_stack.discard(n)
                    scc.append(n)
                    if n == node:
                        break
                if len(scc) > 1 or node in adj.get(node, ()):
                    out.append(sorted(scc))
    return out


def _one_cycle_in(adj: Dict[str, Set[str]], scc: List[str]) -> List[str]:
    """Extract ONE cycle from a cyclic SCC (walk inside the component
    until a node repeats) — length-unbounded, so no ring escapes."""
    members = set(scc)
    start = scc[0]
    path = [start]
    pos = {start: 0}
    node = start
    while True:
        nxt = min(n for n in adj.get(node, ()) if n in members)
        if nxt in pos:
            return path[pos[nxt]:]
        pos[nxt] = len(path)
        path.append(nxt)
        node = nxt


def find_cycles(graph: LockGraph) -> List[List[str]]:
    """Every distinct elementary cycle reachable in the edge set, as
    node lists (first node repeated implicitly).  Enumeration is
    length-bounded for readable multi-cycle reports, but an SCC safety
    net guarantees NO cyclic component escapes unreported: any cyclic
    SCC none of whose nodes appear in an enumerated cycle contributes
    one (length-unbounded) representative cycle — 'an absent cycle is
    a real guarantee' holds for rings of any length."""
    adj: Dict[str, Set[str]] = {}
    for (a, b) in graph.edges:
        adj.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen: Set[frozenset] = set()

    for start in sorted(adj):
        # DFS from each node, only keeping cycles that return to start
        # through nodes >= start (each cycle found exactly once from
        # its smallest node).
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(path))
                    continue
                if nxt < start or nxt in path:
                    continue
                if len(path) < 12:
                    stack.append((nxt, path + [nxt]))
    covered = {n for c in cycles for n in c}
    for scc in _cyclic_sccs(adj):
        if not covered.intersection(scc):
            cyc = _one_cycle_in(adj, scc)
            key = frozenset(cyc)
            if key not in seen:
                seen.add(key)
                cycles.append(cyc)
                covered.update(cyc)
    return cycles


def check(graph: LockGraph) -> List[Violation]:
    """RT010 violations, one per cycle, anchored at the first static
    edge site in the cycle (runtime-only cycles anchor at line 0 of
    the runtime pseudo-file)."""
    out = []
    for cycle in find_cycles(graph):
        ring = cycle + [cycle[0]]
        edge_descrs = []
        anchor = (RUNTIME_SITE, 0)
        for a, b in zip(ring, ring[1:]):
            sites = graph.edges.get((a, b), [])
            static_sites = [s for s in sites if s.file != RUNTIME_SITE]
            pick = static_sites[0] if static_sites else sites[0]
            if anchor[0] == RUNTIME_SITE and static_sites:
                anchor = (pick.file, pick.line)
            edge_descrs.append(f"  {a} -> {b}  [{pick.format()}]")
        msg = (
            "static lock-order cycle (potential deadlock): "
            + " -> ".join(ring)
            + " — two threads interleaving these orders can block "
              "forever, even though no test has executed this "
              "schedule\n"
            + "\n".join(edge_descrs)
        )
        out.append(Violation(anchor[0], anchor[1], "RT010", msg))
    out.sort(key=lambda v: (v.path, v.line))
    return out


def lint_tree(paths: Iterable[str],
              runtime_edges: Optional[Iterable[Tuple[str, str]]] = None,
              ) -> Tuple[LockGraph, List[Violation]]:
    """The whole-tree pass CI runs: build, merge runtime edges, check."""
    graph = build_graph(paths)
    if runtime_edges:
        merge_runtime_edges(graph, runtime_edges)
    return graph, check(graph)


__all__ = [
    "AMBIG_CAP",
    "EdgeSite",
    "LockGraph",
    "RUNTIME_SITE",
    "build_graph",
    "check",
    "find_cycles",
    "lint_tree",
    "load_runtime_edges",
    "merge_runtime_edges",
]
