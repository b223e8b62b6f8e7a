"""rtpulint — AST-based static analyzer for redisson_tpu_torch's own
invariants.

The JAX package's analyser (``redisson_tpu/analysis/rtpulint.py``) with
the port's names: the same rules, roles, suppression syntax and audit,
with the chaos imports of ``redisson_tpu_torch`` (RT003) and torch's
blocking calls (RT001) added.  Every rule is a review finding turned
into a check:

RT001  No blocking call (``time.sleep``, socket ``sendall``/``recv``,
       ``select.select``, ``.result()``, a device sync —
       ``torch.cuda.synchronize()``, a stream's or event's
       ``.synchronize()``, ``.item()``/``.tolist()`` —, a D2H copy
       (``.cpu()``, the executor's ``_host_view``), an H2D transfer
       (the executor's ``_to_device``), device row I/O, ``drain()``,
       K1's build and load (``_build.build``/``_build.load``); the JAX
       spellings ``.block_until_ready()``, ``device_put`` and ``_jit``
       stay) inside a ``with <lock>:`` body — or between ``<lock>.acquire()``
       and ``<lock>.release()`` — in the dispatch/engine/cache/serve/
       tenancy modules.  Condition ``.wait()``/``.wait_for()`` are
       exempt (they RELEASE the lock while blocked).
RT002  No ``settimeout()`` on a socket reachable through shared state
       (an attribute): the socket's timeout is owned by its reader
       thread; a cross-thread mutation shrinks an unrelated wait.
       Sockets held in locals (created and owned by this function) are
       fine.
RT003  Chaos imports must be module-top (a per-call ``sys.modules``
       lookup on the DISABLED path taxes every dispatch), and
       ``chaos.fire(...)`` call sites must be guarded by
       ``if chaos.ENABLED:`` (the zero-overhead-when-disabled
       contract).
RT004  Every config key the RESP layer serves live (the CONFIG GET/SET
       table) must have a bounds-validation arm and an INFO section
       mention.  Boot-only ``Config`` fields are out of scope — they
       never enter the served table.
RT005  Metric label values must be plain values routed through the
       bounded-cardinality registry helpers: no f-string/concat/
       ``.format`` label elements (composite labels defeat the
       per-family cardinality cap), and no ``Family(...)`` construction
       outside the registry itself.
RT006  A module-level dict that grows under non-constant (object/tenant
       name) keys must have a prune path in the same module
       (``pop``/``del``/``clear`` or a ``*prune*`` function touching
       it) — the rising-floor idiom.  Name-churn workloads otherwise
       leak one entry per name ever seen.
RT007  Deadline propagation: a function that accepts a ``deadline``
       parameter must thread it into every coalescer ``submit`` /
       ``HintedFuture`` it makes, and must not issue an unbounded
       ``.result()``/``.wait()`` (no arguments at all) — dropping the
       budget mid-path recreates the class of 120 s hangs behind
       a deadline the caller thought was live.
RT008  Near-cache epoch-bump pairing: a mutating engine path (one that
       submits device work) must bump the write epoch at entry AND
       exit — a single bare ``note_write``/``note_structural`` call
       next to a submit re-opens the capture-window race the
       ``_EpochGuard`` entry+exit discipline closed; and a
       ``_nc_mutate(...)`` guard that is not used as a context manager
       never runs at all.
RT009  Future-resolution completeness: a locally created
       ``Future``/``HintedFuture`` must be resolved
       (``set_result``/``set_exception``/``cancel``), returned, or
       handed off on every path — including exception arms: resolving
       futures inside a ``try`` whose ``except`` swallows (neither
       raises, returns, nor resolves) strands the waiter (the
       stranded-in-flight-charge class).
RT010  Static lock-order cycle (whole-tree pass, analysis/lockgraph.py):
       the witness-named lock graph extracted across every call path
       must stay acyclic, merged with any runtime witness edges — a
       cycle is a potential deadlock even if no test ever ran the
       schedule.  Suppress a by-design edge at its inner-acquisition
       line.
RT011  Span-lifecycle completeness (the RT009 analog for OpSpan/trace
       spans): a locally created span — ``*.spans.start``,
       ``tracer.maybe_start``/``start``/``start_child``, or a direct
       ``OpSpan``/``TraceSpan`` construction — must reach
       ``finish``/``end``/``abandon`` on every path, or escape
       (returned / stored / handed off).  A stranded span records
       nothing: phase histograms silently under-count and the trace it
       belonged to loses the hop.  Resolving inside a ``try`` whose
       ``except`` swallows strands it the same way.
RT012  One-shot connection licenses (the review
       class: ASKING leaking past PING, the trace prelude surviving an
       errored dispatch): a function that READS a license attribute
       (``.asking``, ``.trace_next`` — incl. the ``getattr`` form)
       must also BURN it (store a falsy constant to the same
       attribute, or call the shared burner
       ``consume_one_shot_licenses``) — or be the granting site (a
       truthy store).  A read-without-burn dispatch path serves a
       later unrelated command under a stale license; fused runs and
       cache hits are dispatch paths too.
RT013  Pooled-socket desync discipline (a review class): an
       ``except OSError``-family arm around wire I/O (``sendall``/
       ``recv``/``connect``/``exchange``/pooled ``request``) must
       DROP the socket — close/abort it, pop it from its pool, call a
       ``*drop*``/``*discard*`` helper, or re-raise.  A swallowed
       OSError leaves unread reply bytes in flight; the next command
       on that socket reads them as its OWN replies (silent
       cross-command corruption).
RT014  Tmp-file persistence discipline (the snapshot/blob/journal
       publish rule): an ``os.replace``/``os.rename`` whose SOURCE is
       a tmp file must be preceded by an ``os.fsync`` in the same
       function (rename-before-fsync publishes a name whose bytes a
       crash can void), and the FINAL path must not escape (return /
       store into shared state / non-path call) before the rename —
       a reference that escapes early points at a file that does not
       durably exist yet.
RT015  Flight-recorder kind discipline (the RT005 bounded-
       cardinality rule applied to event kinds): every
       ``events.emit(kind, …)`` call site must pass the kind as a
       plain string LITERAL registered in the obs/events.py ``KINDS``
       catalog.  A dynamic kind (f-string, concat, variable) defeats
       the catalog's cardinality bound on ``rtpu_events_emitted`` and
       hides the emit point from the catalog audit; an unregistered
       literal would raise ValueError at runtime — on a control-plane
       path that may only execute during an outage.

Suppression: ``# rtpulint: disable=RT001 <reason>`` on the offending
line, or alone on the line directly above it.  The reason is mandatory
— a bare disable is itself reported (RT000).  Multiple rules:
``disable=RT001,RT005 <reason>``.

Fixtures can force a module role with a ``# rtpulint: role=<role>``
comment in the first ten lines (roles: dispatch, engine, cache, serve,
tenancy, chaos, host).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional

RULES = {
    "RT000": "malformed rtpulint suppression (missing reason / unknown rule)",
    "RT001": "blocking call while holding a lock",
    "RT002": "settimeout() on a shared-state socket",
    "RT003": "chaos import not module-top / unguarded chaos.fire()",
    "RT004": "served config key without validation arm or INFO mention",
    "RT005": "metric label outside the bounded-cardinality helpers",
    "RT006": "module-level name-keyed dict without a prune path",
    "RT007": "deadline accepted but not threaded into a submit/wait",
    "RT008": "near-cache epoch bump not paired entry+exit",
    "RT009": "created future not resolved/handed off on all paths",
    "RT010": "static lock-order cycle (whole-tree pass)",
    "RT011": "created span not ended/abandoned on all paths",
    "RT012": "one-shot license read without a burn on the dispatch path",
    "RT013": "pooled socket kept after an except-OSError arm",
    "RT014": "tmp-file rename without fsync / final path escapes early",
    "RT015": "event kind not a registered literal from the KINDS catalog",
}

# Roles a rule applies to.  "*" = every non-test module.
_RULE_ROLES = {
    # "journal" (durability/): the group-commit writer and its waiters
    # hold the queue lock around condition waits — blocking I/O under it
    # would stall every producer's append.
    "RT001": {"dispatch", "engine", "cache", "serve", "tenancy", "journal"},
    "RT002": {"serve"},
    "RT003": {"*"},
    "RT004": {"*"},  # self-scoping: only fires where a config table lives
    "RT005": {"*"},
    "RT006": {"*"},
    "RT007": {"*"},  # self-scoping: only fires in deadline-accepting funcs
    "RT008": {"*"},  # self-scoping: only fires next to epoch-bump calls
    "RT009": {"*"},  # self-scoping: only fires where a future is created
    "RT011": {"*"},  # self-scoping: only fires where a span is created
    "RT012": {"*"},  # self-scoping: only fires where a license is read
    # Wire-I/O modules only: serve/ and cluster/ own the pooled sockets
    # (journal/host OSError arms are file-I/O cleanup, not wire desync).
    "RT013": {"serve"},
    "RT014": {"*"},  # self-scoping: only fires at tmp-file renames
    "RT015": {"*"},  # self-scoping: only fires at events.emit call sites
    # RT010 is a WHOLE-TREE rule (analysis/lockgraph.py): it has no
    # per-file check here, but lives in RULES so disable=RT010
    # suppressions parse and the CLI can name it.
}

_ROLE_BY_PATH = (
    ("executor", "dispatch"),
    ("objects", "engine"),
    ("cache", "cache"),
    ("serve", "serve"),
    # Cluster tier: the door/client/supervisor modules hold
    # locks around wire I/O decisions and own sockets — exactly the
    # serve-role bug surface RT001/RT002 were distilled from.
    ("cluster", "serve"),
    ("tenancy", "tenancy"),
    # Residency ladder: transition code holds engine locks
    # around device reads/writes and blob I/O — the engine-role RT001
    # blocking-under-lock surface.
    ("storage", "engine"),
    ("durability", "journal"),
    ("chaos", "chaos"),
    ("analysis", "analysis"),
)


@dataclass
class Violation:
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False
    reason: str = ""

    def format(self) -> str:
        tag = " [suppressed: %s]" % self.reason if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"


# -- suppression / directive parsing ------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*rtpulint:\s*disable=([A-Z0-9,]+)\s*(.*)$"
)
_ROLE_RE = re.compile(r"#\s*rtpulint:\s*role=([a-z]+)")


def _scan_comments(source: str):
    """(suppressions, role, bad_suppressions).

    ``suppressions``: target line -> list[(frozenset_of_rules, reason,
    comment_line)].  A comment sharing a line with code applies to that
    line; a comment-only line applies to the next line (so a long
    offending line can carry its reason above itself).  The comment's
    OWN line rides along for the stale-suppression audit."""
    suppressions: dict[int, list] = {}
    bad: list[tuple[int, str]] = []
    role: Optional[str] = None
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return suppressions, role, bad
    code_lines = set()
    for tok in tokens:
        if tok.type in (
            tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
            tokenize.INDENT, tokenize.DEDENT, tokenize.ENDMARKER,
        ):
            continue
        for ln in range(tok.start[0], tok.end[0] + 1):
            code_lines.add(ln)
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        line = tok.start[0]
        m = _ROLE_RE.search(tok.string)
        if m and line <= 10:
            role = m.group(1)
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2).strip()
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            bad.append((line, f"unknown rule(s) {', '.join(sorted(unknown))}"))
            continue
        if not reason:
            bad.append((line, "suppression has no reason"))
            continue
        target = line if line in code_lines else line + 1
        suppressions.setdefault(target, []).append((rules, reason, line))
    return suppressions, role, bad


# -- shared AST helpers -------------------------------------------------------


def _terminal_name(node) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _base_name(node) -> Optional[str]:
    """Leftmost identifier of an attribute chain (``self._c.fire`` -> 'self')."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


_LOCKISH_RE = re.compile(r"lock|mutex|(^|_)(cv|cond)$|condition")


def _lockish(node) -> Optional[str]:
    """Dotted-ish display name when ``node`` looks like a lock object."""
    ident = _terminal_name(node)
    if ident is None:
        return None
    if _LOCKISH_RE.search(ident.lower().strip("_")):
        return ident
    return None


def _add_parents(tree) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._rtpu_parent = parent  # type: ignore[attr-defined]


def _ancestors(node):
    n = getattr(node, "_rtpu_parent", None)
    while n is not None:
        yield n
        n = getattr(n, "_rtpu_parent", None)


def _walk_no_defs(node):
    """ast.walk that does not descend into nested function/class/lambda
    bodies (code that merely DEFINES deferred work under a lock is not
    executing it there)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


# -- RT001: blocking call while holding a lock --------------------------------

# Attribute names whose CALL blocks the thread (or compiles).  ``wait``
# and ``wait_for`` are deliberately absent: a Condition wait RELEASES
# the lock while blocked, which is the correct idiom under a lock.
_BLOCKING_ATTRS = {
    "sendall": "socket send",
    "recv": "socket recv",
    "recv_into": "socket recv",
    "accept": "socket accept",
    "connect": "socket connect",
    "result": "future/result wait",
    "block_until_ready": "device sync",
    "device_put": "H2D transfer",
    "read_row": "device row read",
    "write_row": "device row write",
    # zero_row blocks exactly like write_row (a device row store); its
    # absence left two residency suppressions dead from day one — the
    # first thing --audit-suppressions caught.
    "zero_row": "device row zero",
    "drain": "coalescer drain barrier",
    "_drain": "coalescer drain barrier",
    "_jit": "jit compilation",
    # torch's counterparts of the JAX entries above.
    "synchronize": "device sync",  # torch.cuda / a stream / an event
    "item": "D2H sync",
    "tolist": "D2H sync",
    "cpu": "D2H copy",
    "_host_view": "D2H copy",  # the executor's pool-row readback
    "_to_device": "H2D transfer",  # the executor's pool-row upload
}

# Calls that block only under one receiver: K1's nvcc build and its
# library load (``_build.build``/``_build.load``), matched by the
# module's name so an unrelated ``build``/``load`` stays quiet.
_BLOCKING_QUALIFIED = {
    ("_build", "build"): "compile",
    ("_build", "load"): "compile",
}


def _blocking_call(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr == "sleep" and _base_name(func.value) in (
            "time", "_time",
        ):
            return "time.sleep"
        if attr == "select" and _base_name(func.value) in (
            "select", "selectors",
        ):
            return "select.select"
        if isinstance(func.value, ast.Name) and \
                (func.value.id, attr) in _BLOCKING_QUALIFIED:
            return _BLOCKING_QUALIFIED[(func.value.id, attr)]
        if attr in _BLOCKING_ATTRS:
            # ``str.join``-style false positives: constant receivers
            # never block.
            if isinstance(func.value, ast.Constant):
                return None
            return _BLOCKING_ATTRS[attr]
        return None
    if isinstance(func, ast.Name):
        if func.id in ("sleep",):
            return "sleep"
        if func.id in ("device_put",):
            return "H2D transfer"
        if func.id == "_jit":
            return "jit compilation"
    return None


def _check_rt001(ctx) -> None:
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _rt001_block(ctx, node.body, {})


def _rt001_block(ctx, stmts, held: dict) -> None:
    """Scan a statement list with ``held`` = {lock name: line}."""
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # nested definitions start with nothing held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            added = []
            for item in stmt.items:
                name = _lockish(item.context_expr)
                if name is not None and name not in held:
                    held[name] = stmt.lineno
                    added.append(name)
            _rt001_block(ctx, stmt.body, held)
            for name in added:
                held.pop(name, None)
            continue
        # acquire()/release() pairs at statement level.
        call = None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        if call is not None and isinstance(call.func, ast.Attribute):
            recv = _lockish(call.func.value)
            if recv is not None:
                if call.func.attr == "acquire":
                    held.setdefault(recv, stmt.lineno)
                    continue
                if call.func.attr == "release":
                    held.pop(recv, None)
                    continue
        if held:
            _rt001_scan_expr(ctx, stmt, held)
        # Recurse into compound statements (their bodies inherit held).
        for block in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, block, None)
            if sub:
                _rt001_block(ctx, sub, held)
        for handler in getattr(stmt, "handlers", ()) or ():
            _rt001_block(ctx, handler.body, held)


def _rt001_scan_expr(ctx, stmt, held: dict) -> None:
    """Flag blocking calls in the EXPRESSIONS of one statement (its
    nested blocks are scanned by _rt001_block's recursion)."""
    exprs = []
    for f in ast.iter_fields(stmt):
        name, value = f
        if name in ("body", "orelse", "finalbody", "handlers"):
            continue
        if isinstance(value, ast.AST):
            exprs.append(value)
        elif isinstance(value, list):
            exprs.extend(v for v in value if isinstance(v, ast.AST))
    for root in exprs:
        nodes = [root] if isinstance(root, ast.Call) else []
        nodes += list(_walk_no_defs(root))
        for n in nodes:
            if not isinstance(n, ast.Call):
                continue
            func = n.func
            if isinstance(func, ast.Attribute) and func.attr in (
                "wait", "wait_for", "notify", "notify_all",
            ):
                continue
            what = _blocking_call(n)
            if what is not None:
                lock, since = next(iter(held.items()))
                ctx.report(
                    "RT001", n.lineno,
                    f"blocking call ({what}) while holding lock "
                    f"{lock!r} (held since line {since}); move the "
                    f"blocking work outside the critical section",
                )


# -- RT002: settimeout on a shared-state socket -------------------------------


def _check_rt002(ctx) -> None:
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "settimeout"):
            continue
        recv = node.func.value
        # A local variable (a socket this function created/owns) may
        # set its own timeout; anything reached through an attribute
        # (self.sock, ctx.sock) is shared state another thread's
        # reader loop relies on.
        if isinstance(recv, ast.Attribute):
            ctx.report(
                "RT002", node.lineno,
                "settimeout() on a socket reachable through shared "
                "state: the timeout belongs to the socket's reader "
                "thread — wait with select() instead (see "
                "_ConnCtx._send_bounded)",
            )


# -- RT003: chaos import/guard discipline -------------------------------------


# The packages whose ``chaos`` module the rule knows: the port's own
# and the JAX package's spelling, which the shared fixtures use.
_CHAOS_PACKAGES = ("redisson_tpu_torch", "redisson_tpu")


def _chaos_aliases(tree) -> set:
    aliases = {"chaos", "_chaos"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith(_CHAOS_PACKAGES):
            for a in node.names:
                if a.name == "chaos":
                    aliases.add(a.asname or a.name)
    return aliases


def _is_chaos_module(mod: str) -> bool:
    return any(
        mod == f"{pkg}.chaos" or mod.startswith(f"{pkg}.chaos.")
        for pkg in _CHAOS_PACKAGES
    )


def _is_chaos_import(node) -> bool:
    if isinstance(node, ast.Import):
        return any(_is_chaos_module(a.name) for a in node.names)
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        if mod in _CHAOS_PACKAGES:
            return any(a.name == "chaos" for a in node.names)
        return _is_chaos_module(mod)
    return False


def _guarded_by_enabled(node, aliases: set) -> bool:
    """True when an ancestor ``if`` tests ``<alias>.ENABLED``, or the
    enclosing function opens with ``if not <alias>.ENABLED: return``."""
    func = None
    for anc in _ancestors(node):
        if isinstance(anc, ast.If) and _mentions_enabled(anc.test, aliases):
            return True
        if func is None and isinstance(
            anc, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            func = anc
    if func is not None:
        for stmt in func.body:
            if getattr(stmt, "lineno", 10**9) >= node.lineno:
                break
            if (
                isinstance(stmt, ast.If)
                and isinstance(stmt.test, ast.UnaryOp)
                and isinstance(stmt.test.op, ast.Not)
                and _mentions_enabled(stmt.test.operand, aliases)
                and any(isinstance(s, (ast.Return, ast.Raise))
                        for s in stmt.body)
            ):
                return True
    return False


def _mentions_enabled(test, aliases: set) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "ENABLED" and \
                isinstance(n.value, ast.Name) and n.value.id in aliases:
            return True
    return False


def _check_rt003(ctx) -> None:
    if ctx.role == "chaos":
        return  # the engine itself is exempt
    aliases = _chaos_aliases(ctx.tree)
    for node in ast.walk(ctx.tree):
        if _is_chaos_import(node) and any(
            isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
            for a in _ancestors(node)
        ):
            ctx.report(
                "RT003", node.lineno,
                "chaos imported inside a function: hoist to module top "
                "(per-call sys.modules lookups tax the DISABLED path)",
            )
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "fire"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in aliases
        ):
            if not _guarded_by_enabled(node, aliases):
                ctx.report(
                    "RT003", node.lineno,
                    f"{node.func.value.id}.fire() without an "
                    f"'if {node.func.value.id}.ENABLED:' guard "
                    "(zero-overhead-when-disabled contract)",
                )


# -- RT004: served config surface coherence -----------------------------------


def _dict_literal_keys(d: ast.Dict):
    for k in d.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            yield k.value, k.lineno


def _str_constants(node) -> set:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def _check_rt004(ctx) -> None:
    keys: list[tuple[str, int]] = []
    validated: set = set()
    info_strs: set = set()
    classes = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.ClassDef)]
    funcs = [
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for cls in classes:
        for stmt in cls.body:
            if not isinstance(stmt, ast.Assign):
                continue
            targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if not targets:
                continue
            name = targets[0]
            if name.endswith("_CONFIG_KEYS") or name == "_CONFIG_KEYS":
                if isinstance(stmt.value, ast.Dict):
                    keys.extend(_dict_literal_keys(stmt.value))
            elif "KEYS" in name:
                # Membership sets routed through a validator
                # (_OVERLOAD_KEYS -> _validate_overload_config).
                validated |= _str_constants(stmt.value)
    for fn in funcs:
        if fn.name.endswith("_config_table_init"):
            for n in ast.walk(fn):
                if isinstance(n, ast.Dict):
                    keys.extend(_dict_literal_keys(n))
                elif (
                    isinstance(n, ast.Assign)
                    and isinstance(n.targets[0], ast.Subscript)
                    and isinstance(n.targets[0].slice, ast.Constant)
                    and isinstance(n.targets[0].slice.value, str)
                ):
                    keys.append((n.targets[0].slice.value, n.lineno))
        if "validate" in fn.name or fn.name == "_cmd_CONFIG":
            validated |= _str_constants(fn)
        if fn.name == "_cmd_INFO" or "_info" in fn.name:
            info_strs |= _str_constants(fn)
    if not keys:
        return
    seen = set()
    for key, line in keys:
        if key in seen:
            continue
        seen.add(key)
        missing = []
        if not _rt004_validated(key, validated):
            missing.append("no CONFIG SET bounds-validation arm")
        if not _rt004_in_info(key, info_strs):
            missing.append("no INFO section mention")
        if missing:
            ctx.report(
                "RT004", line,
                f"served config key '{key}': " + " and ".join(missing),
            )


def _rt004_validated(key: str, validated: set) -> bool:
    if key in validated:
        return True
    # Prefix arms ("slowlog-", "nearcache-" families).
    return any(
        v.endswith("-") and key.startswith(v) for v in validated
    )


def _rt004_in_info(key: str, info_strs: set) -> bool:
    norm = key.replace("-", "_")
    toks = norm.split("_")
    needles = ["_".join(toks[i:]) for i in range(len(toks))
               if len(toks) - i >= 2]
    if not needles:
        needles = [norm]
    return any(
        any(needle in s for s in info_strs) for needle in needles
    )


# -- RT005: bounded-cardinality metric labels ---------------------------------


def _dynamic_string(node) -> bool:
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Mod)
    ):
        # "a" + x / "%s" % x label building.
        return any(
            isinstance(n, ast.Constant) and isinstance(n.value, str)
            for n in ast.walk(node)
        )
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "format":
        return True
    return False


def _check_rt005(ctx) -> None:
    in_registry = ctx.rel.replace(os.sep, "/").endswith("obs/registry.py")
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if (
            not in_registry
            and isinstance(node.func, ast.Name)
            and node.func.id == "Family"
        ):
            ctx.report(
                "RT005", node.lineno,
                "Family(...) constructed outside obs/registry.py: use "
                "registry.counter/gauge/histogram (they enforce the "
                "cardinality cap and Prometheus typing)",
            )
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("inc", "observe", "set")
            and node.args
            and isinstance(node.args[0], ast.Tuple)
        ):
            for el in node.args[0].elts:
                if _dynamic_string(el):
                    ctx.report(
                        "RT005", el.lineno,
                        "dynamically-built metric label value "
                        "(f-string/concat/format): composite labels "
                        "defeat the per-family cardinality cap — pass "
                        "the raw value as its own label dimension",
                    )


# -- RT006: module-level name-keyed dicts need a prune path -------------------


def _check_rt006(ctx) -> None:
    module_dicts: dict[str, int] = {}
    for stmt in ctx.tree.body:
        target = None
        value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            target, value = stmt.targets[0].id, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            target, value = stmt.target.id, stmt.value
        if target is None or value is None:
            continue
        is_dict = isinstance(value, ast.Dict) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("dict", "defaultdict", "OrderedDict")
        )
        if is_dict:
            module_dicts[target] = stmt.lineno
    if not module_dicts:
        return
    grows: set = set()
    pruned: set = set()
    for node in ast.walk(ctx.tree):
        # X[expr] = ... with a non-constant key.
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in module_dicts and \
                        not isinstance(t.slice, ast.Constant):
                    grows.add(t.value.id)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in module_dicts:
            if node.func.attr == "setdefault" and node.args and \
                    not isinstance(node.args[0], ast.Constant):
                grows.add(node.func.value.id)
            if node.func.attr in ("pop", "popitem", "clear"):
                pruned.add(node.func.value.id)
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in module_dicts:
                    pruned.add(t.value.id)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                "prune" in node.name:
            for n in ast.walk(node):
                if isinstance(n, ast.Name) and n.id in module_dicts:
                    pruned.add(n.id)
    for name in sorted(grows - pruned):
        ctx.report(
            "RT006", module_dicts[name],
            f"module-level dict {name!r} grows under non-constant keys "
            "but has no prune path (pop/del/clear or a *prune* "
            "function): name-churn leaks one entry per name forever — "
            "use the rising-floor idiom (see SketchNearCache._epochs)",
        )


# -- RT007: deadline propagation ----------------------------------------------


def _mentions_name(node, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == name:
            return True
    return False


def _call_threads_deadline(call: ast.Call) -> bool:
    if any(kw.arg == "deadline" for kw in call.keywords if kw.arg):
        return True
    return any(_mentions_name(a, "deadline") for a in call.args) or any(
        _mentions_name(kw.value, "deadline") for kw in call.keywords
    )


def _check_rt007(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = fn.args
        params = {
            a.arg for a in (
                args.args + args.posonlyargs + args.kwonlyargs
            )
        }
        if "deadline" not in params:
            continue
        for node in _walk_no_defs(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            callee = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if callee is None:
                continue
            if callee in ("submit", "HintedFuture"):
                if not _call_threads_deadline(node):
                    ctx.report(
                        "RT007", node.lineno,
                        f"{callee}(...) inside a deadline-accepting "
                        f"function does not thread the deadline through "
                        f"— the budget dies here and the op can outlive "
                        f"it (pass deadline=...)",
                    )
            elif callee in ("result", "wait") and not node.args \
                    and not node.keywords:
                ctx.report(
                    "RT007", node.lineno,
                    f".{callee}() with no bound inside a deadline-"
                    f"accepting function waits forever past the "
                    f"caller's budget — bound it by the residual "
                    f"deadline",
                )


# -- RT008: near-cache epoch-bump pairing -------------------------------------


_BUMP_ATTRS = ("note_write", "note_structural")


def _check_rt008(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        bumps: list = []
        submits = 0
        for node in _walk_no_defs(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in _BUMP_ATTRS:
                    bumps.append(node.lineno)
                elif f.attr in ("submit", "_submit"):
                    submits += 1
            # A guard constructed but thrown away never bumps at all.
            if (
                isinstance(f, ast.Attribute) and f.attr == "_nc_mutate"
                or isinstance(f, ast.Name) and f.id == "_nc_mutate"
            ):
                parent = getattr(node, "_rtpu_parent", None)
                if isinstance(parent, ast.Expr):
                    ctx.report(
                        "RT008", node.lineno,
                        "_nc_mutate(...) discarded — the epoch guard "
                        "only bumps as a context manager: write "
                        "`with self._nc_mutate(name):` around the "
                        "mutation",
                    )
        # A properly guarded path contributes NO bare bump calls (the
        # guard holds the bound methods as values), so one bare bump
        # next to a submit is suspicious even when a sibling path in
        # the same function uses the `with _nc_mutate` form.
        if submits and len(bumps) == 1:
            ctx.report(
                "RT008", bumps[0],
                "mutating path bumps the near-cache epoch exactly once "
                "— the discipline is entry AND exit (a read captured in "
                "the entry→submit window must not install): wrap the "
                "mutation in `with self._nc_mutate(name):`",
            )


# -- RT009: future-resolution completeness ------------------------------------


_FUTURE_CTORS = ("Future", "HintedFuture")


def _is_future_ctor(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _FUTURE_CTORS
    if isinstance(f, ast.Attribute):
        return f.attr in _FUTURE_CTORS
    return False


def _check_rt009(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # var -> creation line
        created: dict = {}
        for node in _walk_no_defs(fn):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                target, value = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                target, value = node.target.id, node.value
            else:
                continue
            if isinstance(value, ast.Call) and _is_future_ctor(value):
                created[target] = node.lineno
        if not created:
            continue
        resolved: set = set()
        escaped: set = set()
        for node in _walk_no_defs(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in created
                    and f.attr in ("set_result", "set_exception", "cancel",
                                   "set_running_or_notify_cancel")
                ):
                    resolved.add(f.value.id)
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    for v in created:
                        if _mentions_name(arg, v):
                            escaped.add(v)
            elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                val = node.value
                if val is not None:
                    for v in created:
                        if _mentions_name(val, v):
                            escaped.add(v)
            elif isinstance(node, ast.Assign):
                # aliasing / storing: fut2 = fut, self.x = fut, d[k] = fut
                for v in created:
                    if _mentions_name(node.value, v):
                        escaped.add(v)
        for v, line in created.items():
            if v not in resolved and v not in escaped:
                ctx.report(
                    "RT009", line,
                    f"future {v!r} is created but never resolved, "
                    f"returned, or handed off — every waiter on it "
                    f"blocks until the fetch timeout",
                )
        # Exception arms: resolving inside a try whose handler swallows.
        for node in _walk_no_defs(fn):
            if not isinstance(node, ast.Try):
                continue
            resolves_inside = set()
            for sub in node.body:
                for n in ast.walk(sub):
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id in created
                        and n.func.attr in ("set_result", "set_exception")
                    ):
                        resolves_inside.add(n.func.value.id)
            if not resolves_inside:
                continue
            for handler in node.handlers:
                ok = False
                for n in ast.walk(handler):
                    if isinstance(n, (ast.Raise, ast.Return)):
                        ok = True
                        break
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id in resolves_inside
                        and n.func.attr in ("set_result", "set_exception",
                                            "cancel")
                    ):
                        ok = True
                        break
                if not ok:
                    ctx.report(
                        "RT009", handler.lineno,
                        f"except arm swallows while the try body "
                        f"resolves future(s) {sorted(resolves_inside)} — "
                        f"a failure here strands the waiter: re-raise, "
                        f"return, or set_exception",
                    )


# -- RT011: span-lifecycle completeness (the RT009 analog for spans) ----------


_SPAN_CTORS = ("OpSpan", "TraceSpan")
_SPAN_BEGIN_ATTRS = ("maybe_start", "start_child", "span_scope")
_SPAN_RESOLVERS = ("finish", "end", "abandon")


def _is_span_begin(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _SPAN_CTORS
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr in _SPAN_BEGIN_ATTRS or f.attr in _SPAN_CTORS:
        return True
    if f.attr == "start":
        # ``<...>.spans.start(...)`` (the SpanRecorder begin) and
        # ``tracer.start(...)`` / ``<...>.trace.start(...)`` (a forced
        # trace span).  A bare ``x.start()`` (threads, servers) is NOT a
        # span begin — the owner must look like a span source.
        owner = f.value
        owner_name = None
        if isinstance(owner, ast.Attribute):
            owner_name = owner.attr
        elif isinstance(owner, ast.Name):
            owner_name = owner.id
        return owner_name in ("spans", "trace", "tracer", "tr")
    return False


def _check_rt011(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        created: dict = {}  # var -> creation line
        for node in _walk_no_defs(fn):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target, value = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                target, value = node.target.id, node.value
            else:
                continue
            if isinstance(value, ast.Call) and _is_span_begin(value):
                created[target] = node.lineno
        if not created:
            continue
        resolved: set = set()
        escaped: set = set()
        for node in _walk_no_defs(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in created
                    and f.attr in _SPAN_RESOLVERS
                ):
                    resolved.add(f.value.id)
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    for v in created:
                        if _mentions_name(arg, v):
                            escaped.add(v)
            elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                val = node.value
                if val is not None:
                    for v in created:
                        if _mentions_name(val, v):
                            escaped.add(v)
            elif isinstance(node, ast.Assign):
                # aliasing / storing: seg.span = span, d[k] = span
                for v in created:
                    if _mentions_name(node.value, v):
                        escaped.add(v)
        for v, line in created.items():
            if v not in resolved and v not in escaped:
                ctx.report(
                    "RT011", line,
                    f"span {v!r} is begun but never finished/ended/"
                    f"abandoned, returned, or handed off — it records "
                    f"nothing: phase histograms under-count and its "
                    f"trace loses this hop",
                )
        # Exception arms: ending inside a try whose handler swallows.
        for node in _walk_no_defs(fn):
            if not isinstance(node, ast.Try):
                continue
            ends_inside = set()
            for sub in node.body:
                for n in ast.walk(sub):
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id in created
                        and n.func.attr in ("finish", "end")
                    ):
                        ends_inside.add(n.func.value.id)
            if not ends_inside:
                continue
            for handler in node.handlers:
                ok = False
                for n in ast.walk(handler):
                    if isinstance(n, (ast.Raise, ast.Return)):
                        ok = True
                        break
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id in ends_inside
                        and n.func.attr in _SPAN_RESOLVERS
                    ):
                        ok = True
                        break
                if not ok:
                    ctx.report(
                        "RT011", handler.lineno,
                        f"except arm swallows while the try body ends "
                        f"span(s) {sorted(ends_inside)} — a failure "
                        f"here strands the span: re-raise, return, or "
                        f"end(error=True)/abandon",
                    )


# -- RT012: one-shot connection licenses --------------------------------------

# The license attributes of the one-shot class (extend here when a new
# prelude flag lands — the rule then covers it tree-wide for free).
_LICENSE_ATTRS = ("asking", "trace_next")
# Calling any of these burns EVERY license (the shared discipline in
# serve/resp.py that _safe_dispatch and the netsim harnesses ride).
_LICENSE_BURNERS = ("consume_one_shot_licenses",)


def _license_read(node):
    """License attr name a node READS: ``x.asking`` (Load) or
    ``getattr(x, "asking", ...)``."""
    if (
        isinstance(node, ast.Attribute)
        and node.attr in _LICENSE_ATTRS
        and isinstance(node.ctx, ast.Load)
    ):
        return node.attr
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "getattr"
        and len(node.args) >= 2
        and isinstance(node.args[1], ast.Constant)
        and node.args[1].value in _LICENSE_ATTRS
    ):
        return node.args[1].value
    return None


def _check_rt012(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        reads: dict = {}   # attr -> first read line
        burned: set = set()
        granted: set = set()
        calls_burner = False
        for node in _walk_no_defs(fn):
            attr = _license_read(node)
            if attr is not None:
                # Lexically FIRST read (walk order is not line order).
                reads[attr] = min(
                    reads.get(attr, node.lineno), node.lineno
                )
            if isinstance(node, ast.Call):
                f = node.func
                callee = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None
                )
                if callee in _LICENSE_BURNERS:
                    calls_burner = True
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr in _LICENSE_ATTRS:
                        v = node.value
                        if isinstance(v, ast.Constant) and not v.value:
                            burned.add(t.attr)
                        else:
                            granted.add(t.attr)
        if not reads or calls_burner:
            continue
        for attr, line in sorted(reads.items(), key=lambda kv: kv[1]):
            if attr in burned or attr in granted:
                continue
            ctx.report(
                "RT012", line,
                f"one-shot license {attr!r} is read but never burned "
                f"on this dispatch path (no falsy store, no "
                f"consume_one_shot_licenses call): a stale license "
                f"leaks to a later unrelated command — burn it, or "
                f"route the consumption through the shared burner",
            )


# -- RT013: pooled-socket desync discipline -----------------------------------

# EAGAIN (BlockingIOError) / EINTR (InterruptedError) are RETRYABLE
# nonblocking outcomes, not desync — deliberately absent.
_RT013_ERRORS = frozenset((
    "OSError", "IOError", "ConnectionError", "ConnectionResetError",
    "ConnectionAbortedError", "BrokenPipeError", "TimeoutError",
    "timeout", "error",
))
# Calls on a receiver that put REPLY-BEARING bytes in flight on it
# (accept/connect carry no replies yet — a failed one cannot desync).
_RT013_IO_ATTRS = frozenset((
    "sendall", "send", "recv", "recv_into", "makefile", "request",
    "exchange",
))
_RT013_IO_FUNCS = frozenset(("exchange",))
_RT013_DROP_RE = re.compile(
    r"close|abort|drop|discard|invalidate|reset|shutdown|kill",
    re.IGNORECASE,
)
# A truthy flag like ``dead = True`` / ``eof = True`` defers the drop
# to the teardown path the flag drives — the reactor idiom.
_RT013_DOOM_FLAG_RE = re.compile(r"dead|eof|closed|broken|gone|fail")


def _rt013_catches_oserror(handler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except swallows OSError too
    names = []
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in nodes:
        name = _terminal_name(n)
        if name is not None:
            names.append(name)
    return any(n in _RT013_ERRORS for n in names)


def _rt013_try_touches_wire(body) -> bool:
    for stmt in body:
        for node in _walk_no_defs(stmt):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _RT013_IO_ATTRS:
                # Constant receivers (str.join-style) never carry wire.
                if not isinstance(f.value, ast.Constant):
                    return True
            if isinstance(f, ast.Name) and f.id in _RT013_IO_FUNCS:
                return True
        # The statement itself may BE the wire call (walk above covers
        # expressions; nothing else needed).
    return False


def _rt013_handler_drops(handler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True  # propagates: the caller's discipline applies
        if isinstance(node, ast.Delete):
            return True  # del pool[...]: dropped
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and \
                        _RT013_DOOM_FLAG_RE.search(t.id.lower()) and \
                        isinstance(node.value, ast.Constant) and \
                        node.value.value:
                    return True  # doom flag: teardown path drops it
        if isinstance(node, ast.Call):
            f = node.func
            callee = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if callee is not None and (
                callee in ("pop", "clear")
                or _RT013_DROP_RE.search(callee)
            ):
                return True
    return False


def _check_rt013(ctx) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        if not _rt013_try_touches_wire(node.body):
            continue
        if node.finalbody and _rt013_handler_drops(
            ast.Module(body=list(node.finalbody), type_ignores=[])
        ):
            continue  # a finally that drops covers every arm
        for handler in node.handlers:
            if not _rt013_catches_oserror(handler):
                continue
            if _rt013_handler_drops(handler):
                continue
            ctx.report(
                "RT013", handler.lineno,
                "except-OSError arm around wire I/O neither drops the "
                "socket (close/abort/pop/*drop*) nor re-raises: unread "
                "reply bytes stay in flight and the next command on "
                "this socket reads them as its OWN replies — drop the "
                "connection, never return it to the pool",
            )


# -- RT014: tmp-file fsync-then-rename discipline ------------------------------

# Path-shaping calls a final-path name may feed BEFORE the rename
# without "escaping" (building the path is not publishing it).
_RT014_PATH_FUNCS = frozenset((
    "join", "replace", "rename", "fspath", "basename", "dirname",
    "abspath", "realpath", "encode", "fsync", "stat", "exists",
))


def _rt014_tmpish(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "tmp" in n.id.lower():
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and \
                "tmp" in n.value.lower():
            return True
    return False


def _check_rt014(ctx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        replaces: list = []  # (lineno, dst node)
        fsync_lines: list = []
        for node in _walk_no_defs(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in (
                "replace", "rename",
            ) and _base_name(f.value) == "os" and len(node.args) >= 2:
                if _rt014_tmpish(node.args[0]):
                    replaces.append((node.lineno, node.args[1]))
            if isinstance(f, ast.Attribute) and f.attr == "fsync":
                fsync_lines.append(node.lineno)
        if not replaces:
            continue
        for line, dst in replaces:
            if not any(fl < line for fl in fsync_lines):
                ctx.report(
                    "RT014", line,
                    "tmp-file rename without a preceding fsync: the "
                    "rename publishes a name whose bytes a crash can "
                    "void — fsync the tmp file (and the directory) "
                    "BEFORE os.replace",
                )
            # Escape analysis only when the final path is a plain
            # variable (a composed join(...) never materialized, so it
            # cannot have escaped).  ALL-CAPS names are module-level
            # constant paths — globally known by definition, so a
            # pre-rename read (a staleness check on the EXISTING file)
            # is not an escape of the fresh one.
            if not isinstance(dst, ast.Name) or dst.id.isupper():
                continue
            dname = dst.id
            for node in _walk_no_defs(fn):
                nline = getattr(node, "lineno", None)
                if nline is None or nline >= line:
                    continue
                if isinstance(node, ast.Return) and node.value is not None \
                        and _mentions_name(node.value, dname):
                    ctx.report(
                        "RT014", nline,
                        f"final path {dname!r} returned before the "
                        f"rename: callers hold a name that does not "
                        f"durably exist yet",
                    )
                elif isinstance(node, ast.Assign) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in node.targets
                ) and _mentions_name(node.value, dname):
                    ctx.report(
                        "RT014", nline,
                        f"final path {dname!r} stored into shared "
                        f"state before the rename — the reference "
                        f"escapes ahead of the durable publish",
                    )
                elif isinstance(node, ast.Call):
                    f = node.func
                    callee = f.attr if isinstance(f, ast.Attribute) \
                        else (f.id if isinstance(f, ast.Name) else None)
                    if callee in _RT014_PATH_FUNCS or callee is None:
                        continue
                    if any(
                        _mentions_name(a, dname)
                        for a in list(node.args)
                        + [kw.value for kw in node.keywords]
                    ):
                        ctx.report(
                            "RT014", nline,
                            f"final path {dname!r} passed to "
                            f"{callee}() before the rename — the "
                            f"reference escapes ahead of the durable "
                            f"publish",
                        )


# -- RT015: flight-recorder kind discipline -----------------------------------

# Mirror of obs/events.py KINDS — kept literal so the linter stays a
# pure-AST pass with no runtime imports (the lockgraph/RT004 precedent);
# tests/test_torch_rtpulint.py pins this set equal to events.KINDS both
# ways,
# so adding an emit kind means touching catalog AND mirror on purpose.
_RT015_KINDS = frozenset((
    "failover.detected",
    "failover.vote",
    "failover.election.won",
    "failover.election.lost",
    "failover.takeover.sent",
    "failover.takeover.applied",
    "rebalance.coordinator",
    "rebalance.wave.planned",
    "rebalance.wave.executed",
    "rebalance.wave.skipped",
    "repl.full_resync",
    "repl.partial_resync",
    "repl.link.down",
    "repl.stale_read",
    "repl.wait.timeout",
    "health.breaker.open",
    "health.breaker.close",
    "health.reconcile.failed",
    "residency.promote",
    "residency.demote",
    "residency.spill",
    "multicore.worker.spawn",
    "multicore.worker.death",
    "multicore.handoff.broken",
    "config.set",
    "doctor.finding",
    "doctor.clear",
    "doctor.canary",
))

# Receiver names that mark an emit() call as a flight-recorder emit
# (the repo idiom: `events = getattr(obs, "events", None)` locals,
# `self.obs.events`, and the `_events()` accessor helpers).
_RT015_RECEIVERS = ("events", "_events")


def _rt015_is_recorder_emit(node) -> bool:
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "emit"):
        return False
    recv = f.value
    if isinstance(recv, ast.Name):
        return recv.id in _RT015_RECEIVERS
    if isinstance(recv, ast.Attribute):
        return recv.attr in _RT015_RECEIVERS
    if isinstance(recv, ast.Call):
        g = recv.func
        name = g.attr if isinstance(g, ast.Attribute) else (
            g.id if isinstance(g, ast.Name) else None
        )
        return name in _RT015_RECEIVERS
    return False


def _check_rt015(ctx) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not _rt015_is_recorder_emit(node):
            continue
        kind = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "kind"),
            None,
        )
        if kind is None:
            ctx.report(
                "RT015", node.lineno,
                "events.emit() without a kind argument",
            )
            continue
        if not (isinstance(kind, ast.Constant)
                and isinstance(kind.value, str)):
            ctx.report(
                "RT015", kind.lineno,
                "dynamically-built event kind: emit kinds must be "
                "plain string literals from the obs/events.py KINDS "
                "catalog (one literal per branch — the catalog audit "
                "and the rtpu_events_emitted cardinality bound both "
                "depend on it)",
            )
            continue
        if kind.value not in _RT015_KINDS:
            ctx.report(
                "RT015", kind.lineno,
                f"event kind {kind.value!r} is not registered in the "
                f"obs/events.py KINDS catalog — register it there "
                f"(and in the linter mirror) before emitting it",
            )


_CHECKS = {
    "RT001": _check_rt001,
    "RT002": _check_rt002,
    "RT003": _check_rt003,
    "RT004": _check_rt004,
    "RT005": _check_rt005,
    "RT006": _check_rt006,
    "RT007": _check_rt007,
    "RT008": _check_rt008,
    "RT009": _check_rt009,
    "RT011": _check_rt011,
    "RT012": _check_rt012,
    "RT013": _check_rt013,
    "RT014": _check_rt014,
    "RT015": _check_rt015,
}


# -- entry points -------------------------------------------------------------


@dataclass
class _FileCtx:
    path: str
    rel: str
    role: str
    tree: ast.AST
    suppressions: dict
    violations: list = field(default_factory=list)

    def report(self, rule: str, line: int, message: str) -> None:
        for rules, reason, _cline in self.suppressions.get(line, ()):
            if rule in rules:
                self.violations.append(Violation(
                    self.rel, line, rule, message,
                    suppressed=True, reason=reason,
                ))
                return
        self.violations.append(Violation(self.rel, line, rule, message))


def _role_of(rel: str) -> str:
    parts = rel.replace(os.sep, "/").split("/")
    for marker, role in _ROLE_BY_PATH:
        if marker in parts[:-1]:
            return role
    return "host"


def lint_source(source: str, rel: str = "<string>",
                role: Optional[str] = None,
                rules: Optional[Iterable[str]] = None) -> list:
    """Lint one source string; returns [Violation] (suppressed
    included, flagged)."""
    suppressions, directive_role, bad = _scan_comments(source)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Violation(rel, e.lineno or 1, "RT000",
                          f"syntax error: {e.msg}")]
    _add_parents(tree)
    eff_role = role or directive_role or _role_of(rel)
    ctx = _FileCtx(rel, rel, eff_role, tree, suppressions)
    for line, why in bad:
        ctx.violations.append(Violation(rel, line, "RT000", why))
    wanted = set(rules) if rules else set(_CHECKS)
    for rule, check in _CHECKS.items():
        if rule not in wanted:
            continue
        applies = _RULE_ROLES[rule]
        if "*" in applies or eff_role in applies:
            check(ctx)
    ctx.violations.sort(key=lambda v: (v.line, v.rule))
    return ctx.violations


def lint_file(path: str, root: Optional[str] = None,
              rules: Optional[Iterable[str]] = None) -> list:
    rel = os.path.relpath(path, root) if root else path
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel=rel, rules=rules)


def _iter_py(path: str):
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [
            d for d in dirnames
            if d not in ("__pycache__", ".git", "fixtures")
        ]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _files_of(paths: Iterable[str]) -> list:
    files: list = []
    for path in paths:
        files.extend(_iter_py(path))
    return files


def _lint_one(args) -> list:
    """Module-level per-file worker (picklable for --jobs)."""
    path, rules = args
    return lint_file(path, rules=list(rules) if rules else None)


def _map_files(worker, files: list, rules, jobs: int) -> list:
    """Run ``worker`` over the files — serially, or on ``jobs``
    processes (0 = cpu count).  Results come back in FILE ORDER either
    way, so parallel findings are byte-identical to serial (asserted
    in tests/test_torch_rtpulint.py)."""
    rules_t = tuple(rules) if rules else None
    tasks = [(fp, rules_t) for fp in files]
    if jobs == 1 or len(files) < 2:
        return [worker(t) for t in tasks]
    if jobs <= 0:
        jobs = os.cpu_count() or 1
    try:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=min(jobs, len(files))
        ) as ex:
            return list(ex.map(worker, tasks))
    except (OSError, ImportError, NotImplementedError):
        # Platforms without fork/semaphores: serial fallback, same
        # findings.
        return [worker(t) for t in tasks]


def lint_paths(paths: Iterable[str],
               rules: Optional[Iterable[str]] = None,
               jobs: int = 1) -> list:
    files = _files_of(paths)
    results = _map_files(_lint_one, files, rules, jobs)
    return [v for vs in results for v in vs]


# -- stale-suppression audit (--audit-suppressions) ---------------------------


@dataclass
class StaleSuppression:
    """A ``# rtpulint: disable=`` comment whose named rule(s) no longer
    fire at its target line — dead armor that silences nothing today
    and could silence a REAL future finding at that line."""

    path: str
    line: int        # the comment's own line
    rules: tuple
    reason: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}: stale suppression "
            f"disable={','.join(self.rules)} — no named rule fires "
            f"here anymore (reason was: {self.reason})"
        )


def _stale_of(path: str, suppressions, used) -> list:
    """Suppression table vs the (line, rule) pairs that actually
    fired suppressed at ``path`` — whatever survives is stale."""
    out = []
    for target, entries in suppressions.items():
        for rules, reason, cline in entries:
            if any((target, r) in used for r in rules):
                continue
            out.append(StaleSuppression(
                path, cline, tuple(sorted(rules)), reason
            ))
    return out


def _audit_one(args) -> list:
    """Per-file stale scan: every suppression comment vs the rules
    that actually fired at its target line.  RT010-naming comments are
    returned with a ``pending_rt010`` marker — only the whole-tree
    lock-graph pass knows whether they swallowed an edge."""
    path, _rules = args
    with open(path, encoding="utf-8") as f:
        source = f.read()
    suppressions, _role, _bad = _scan_comments(source)
    if not suppressions:
        return []
    vs = lint_source(source, rel=path)
    used = {(v.line, v.rule) for v in vs if v.suppressed}
    return _stale_of(path, suppressions, used)


def _audit_from_violations(path: str, used) -> list:
    """The no-relint variant: the caller already ran an all-rules
    lint pass over ``path`` and hands us its suppressed-hit set."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    suppressions, _role, _bad = _scan_comments(source)
    if not suppressions:
        return []
    return _stale_of(path, suppressions, used)


def audit_paths(paths: Iterable[str], jobs: int = 1,
                rt010_sites: Optional[set] = None,
                violations: Optional[list] = None) -> list:
    """Every stale suppression under ``paths`` (see
    :class:`StaleSuppression`).  ``rt010_sites`` is the lock-graph
    pass's consumed-comment set (``LockGraph.suppressed_sites``);
    comments naming RT010 count as live when their site is in it —
    when None (no whole-tree pass ran), RT010-naming comments are
    skipped rather than guessed at.  ``violations`` is a completed
    ALL-RULES lint pass over the same paths: when given, the audit
    reuses its suppressed-hit set instead of re-linting every file
    (the CLI's case — never pass a ``--rule``-filtered result, whose
    missing rules would all read as stale)."""
    files = _files_of(paths)
    if violations is not None:
        used_by_file: dict = {}
        for v in violations:
            if v.suppressed:
                used_by_file.setdefault(v.path, set()).add(
                    (v.line, v.rule)
                )
        results = [
            _audit_from_violations(fp, used_by_file.get(fp, ()))
            for fp in files
        ]
    else:
        results = _map_files(_audit_one, files, None, jobs)
    out = []
    for stales in results:
        for s in stales:
            if "RT010" in s.rules:
                if rt010_sites is None:
                    continue  # unverifiable without the tree pass
                if (s.path, s.line) in rt010_sites:
                    continue  # the graph consumed it: live
            out.append(s)
    return out
