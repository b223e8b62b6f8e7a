"""``tests/test_rtpulint.py`` on the port's own analyser
(``redisson_tpu_torch/analysis/rtpulint.py`` and its CLI, ``python -m
redisson_tpu_torch.analysis``).

``port_namespace`` rebinds the reference module: its globals and the
imports inside its bodies reach the port's analyser, and ``_port_code``
rewrites the string constants that name the package in its bodies (the
CLI module, the tree to lint, the reactor's snippet path), so every test
reads ``tests/fixtures/rtpulint/`` as it is and gates the port's tree.
All 20 reference tests run; none is skipped.

Added for the port:

* each torch entry of RT001's blocking list (a device sync, a D2H sync
  or copy, an H2D transfer, K1's build and load) trips RT001 under a
  lock in an executor-role module and stays silent outside it; a bare
  ``build``/``load`` does not trip;
* the port's chaos imports inside a function trip RT003;
* the self-scoping rules find the port's tables: RT004 the served
  CONFIG table, RT012 the license burner's readers, RT015 the
  ``obs/events`` KINDS catalog (a mutated emit kind trips it);
* the differential: with ``--show-suppressed`` the port's analyser
  reports every (path, line, rule) the reference's reports over
  ``redisson_tpu_torch/``.
"""

import os
import re
import subprocess
import sys
import types

import pytest

import test_rtpulint as _ref
from redisson_tpu_torch.analysis import rtpulint
from test_torch_cluster import port_namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "redisson_tpu_torch")

# String constants of the reference bodies that name the JAX package.
_CONSTS = {
    "redisson_tpu.analysis": "redisson_tpu_torch.analysis",
    "redisson_tpu": "redisson_tpu_torch",
    "redisson_tpu/serve/reactor.py": "redisson_tpu_torch/serve/reactor.py",
}


def _port_code(code: types.CodeType) -> types.CodeType:
    consts = tuple(
        _CONSTS.get(c, c) if isinstance(c, str)
        else _port_code(c) if isinstance(c, types.CodeType) else c
        for c in code.co_consts
    )
    return code.replace(co_consts=consts)


def _rebind(ns: dict) -> dict:
    for obj in ns.values():
        fns = [obj] if isinstance(obj, types.FunctionType) else (
            [v for v in vars(obj).values() if isinstance(v, types.FunctionType)]
            if isinstance(obj, type) else [])
        for fn in fns:
            fn.__code__ = _port_code(fn.__code__)
    return ns


globals().update(_rebind(port_namespace(_ref, extra={"RULES": rtpulint.RULES})))


# -- RT001: torch's blocking calls ---------------------------------------------

_TORCH_BLOCKING = {
    "cuda-synchronize": ("torch.cuda.synchronize()", "device sync"),
    "stream-synchronize": ("self._stream.synchronize()", "device sync"),
    "event-synchronize": ("done.synchronize()", "device sync"),
    "item": ("n = t.item()", "D2H sync"),
    "tolist": ("xs = t.tolist()", "D2H sync"),
    "cpu": ("h = t.cpu()", "D2H copy"),
    "host-view": ("h = self._host_view(t)", "D2H copy"),
    "to-device": ("d = self._to_device(pool, t)", "H2D transfer"),
    "k1-build": ("_build.build(['cms_seq'])", "compile"),
    "k1-load": ("lib = _build.load('cms_seq', bind)", "compile"),
}


def _executor_src(stmt: str, under_lock: bool) -> str:
    body = (f"        with self._lock:\n            {stmt}\n" if under_lock
            else f"        with self._lock:\n            pass\n        {stmt}\n")
    return (
        "import threading\n\n"
        "import torch\n\n"
        "from redisson_tpu_torch.ops import _build\n\n\n"
        "class Executor:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def run(self, t, pool, done, bind):\n" + body
    )


@pytest.mark.parametrize("entry", sorted(_TORCH_BLOCKING))
def test_torch_blocking_call_under_a_lock_trips_rt001(entry):
    stmt, what = _TORCH_BLOCKING[entry]
    rel = "redisson_tpu_torch/executor/torch_executor.py"
    got = [v for v in rtpulint.lint_source(_executor_src(stmt, True), rel=rel)
           if v.rule == "RT001"]
    assert len(got) == 1 and f"({what})" in got[0].message, [v.format() for v in got]
    outside = rtpulint.lint_source(_executor_src(stmt, False), rel=rel)
    assert [v for v in outside if v.rule == "RT001"] == []


@pytest.mark.parametrize("stmt", ["build(['cms_seq'])", "lib = load('cms_seq', bind)",
                                  "cfg.build()", "mod.load(path)"])
def test_unqualified_build_and_load_stay_quiet(stmt):
    src = _executor_src(stmt, True).replace(
        "from redisson_tpu_torch.ops import _build\n",
        "from redisson_tpu_torch.ops._build import build, load\n")
    vs = rtpulint.lint_source(src, rel="redisson_tpu_torch/executor/torch_executor.py")
    assert [v for v in vs if v.rule == "RT001"] == []


# -- RT003: the port's chaos imports ---------------------------------------------

@pytest.mark.parametrize("imp", [
    "from redisson_tpu_torch import chaos",
    "from redisson_tpu_torch import chaos as _chaos",
    "import redisson_tpu_torch.chaos",
    "from redisson_tpu_torch.chaos import ChaosSchedule",
])
def test_function_local_port_chaos_import_trips_rt003(imp):
    src = f"def dispatch():\n    {imp}\n    return 1\n"
    vs = rtpulint.lint_source(src, rel="redisson_tpu_torch/objects/engines.py")
    assert [(v.line, v.rule) for v in vs] == [(2, "RT003")]
    top = f"{imp}\n\n\ndef dispatch():\n    return 1\n"
    assert rtpulint.lint_source(top, rel="redisson_tpu_torch/objects/engines.py") == []


def test_unguarded_port_chaos_fire_trips_rt003():
    src = ("from redisson_tpu_torch import chaos as _c\n\n\n"
           "def dispatch(point):\n    _c.fire(point)\n\n\n"
           "def guarded(point):\n    if _c.ENABLED:\n        _c.fire(point)\n")
    vs = rtpulint.lint_source(src, rel="redisson_tpu_torch/executor/coalescer.py")
    assert [(v.line, v.rule) for v in vs] == [(5, "RT003")]


# -- the self-scoping rules find the port's tables -------------------------------

def _port_file(rel):
    with open(os.path.join(PORT_PKG, rel), encoding="utf-8") as f:
        return f.read()


def test_rt004_finds_the_served_config_table():
    """RT004 fires only where a CONFIG table lives: on the port's front
    door it must find the table (its client-compat rows carry reasoned
    suppressions), and a served key stripped of its validation arm and
    INFO mention must trip it."""
    src = _port_file("serve/resp.py")
    rel = "redisson_tpu_torch/serve/resp.py"
    vs = rtpulint.lint_source(src, rel=rel, rules=["RT004"])
    assert vs and all(v.suppressed for v in vs), [v.format() for v in vs]
    assert any("'maxmemory'" in v.message for v in vs)
    row = '        "maxmemory": "0",'
    mutated = src.replace(row, '        "zz-unvalidated-knob": "0",\n' + row, 1)
    assert mutated != src
    live = [v for v in rtpulint.lint_source(mutated, rel=rel, rules=["RT004"])
            if not v.suppressed]
    assert any("zz-unvalidated-knob" in v.message for v in live), [v.format() for v in live]


def test_rt012_finds_the_license_readers():
    src = _port_file("serve/resp.py")
    rel = "redisson_tpu_torch/serve/resp.py"
    vs = rtpulint.lint_source(src, rel=rel, rules=["RT012"])
    assert vs and all(v.suppressed for v in vs)
    # A dispatch path that reads a license and never burns it trips.
    leak = ("\n\ndef _leaky_dispatch(ctx, cmd):\n"
            "    if ctx.asking:\n        return cmd\n    return None\n")
    live = [v for v in rtpulint.lint_source(src + leak, rel=rel, rules=["RT012"])
            if not v.suppressed]
    assert len(live) == 1 and "'asking'" in live[0].message, [v.format() for v in live]


def test_rt015_sees_the_port_emit_sites_and_their_kinds():
    """Every events.emit in the port passes a registered literal; a kind
    changed to an unregistered literal trips RT015 at that line."""
    import ast

    from redisson_tpu_torch.obs.events import KINDS

    sites = []
    for path in rtpulint._files_of([PORT_PKG]):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        sites += [(path, n) for n in ast.walk(tree)
                  if isinstance(n, ast.Call) and rtpulint._rt015_is_recorder_emit(n)]
    assert len(sites) >= 10, "RT015 sees almost no emit site in the port"
    kinds = {n.args[0].value for _p, n in sites if n.args and isinstance(n.args[0], ast.Constant)}
    assert kinds and kinds <= set(KINDS)
    path, node = next((p, n) for p, n in sites if p.endswith("replica.py"))
    with open(path, encoding="utf-8") as f:
        src = f.read()
    kind = node.args[0].value
    mutated = src.replace(f'"{kind}"', '"repl.not.registered"', 1)
    live = [v for v in rtpulint.lint_source(mutated, rel=path, rules=["RT015"])
            if not v.suppressed]
    assert [v.line for v in live] == [node.args[0].lineno], [v.format() for v in live]


# -- the differential: the reference's findings on the port's tree ---------------

_FINDING = re.compile(r"^(\S+?):(\d+): (RT\d{3}) ", re.M)


def test_port_analyser_reports_every_reference_finding_on_the_port_tree():
    """Both analysers over ``redisson_tpu_torch/`` with
    ``--show-suppressed`` (run at once): every (path, line, rule) the
    reference reports, the port's reports too."""
    procs = {
        mod: subprocess.Popen(
            [sys.executable, "-m", mod, "--show-suppressed", "redisson_tpu_torch/"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for mod in ("redisson_tpu.analysis", "redisson_tpu_torch.analysis")
    }
    found = {}
    for mod, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, out + err
        found[mod] = set(_FINDING.findall(out))
    ref, port = found["redisson_tpu.analysis"], found["redisson_tpu_torch.analysis"]
    assert ref, "the reference analyser found nothing on the port's tree"
    assert ref <= port, sorted(ref - port)
