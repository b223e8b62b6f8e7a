"""What the harness and its reference import, compared by whole
top-level module names (``redisson_tpu_torch`` begins with
``redisson_tpu``)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench import spec
from portbench.run import FORBIDDEN
from portbench.tests.conftest import REPO

_RUN_TINY = """
import json, sys
from portbench import run
from portbench.tests.conftest import make_tiny
bench = make_tiny(sys.argv[1], sys.argv[2])
out = run.execute("tiny", 2**31 + 5, 1.0, False, device="cpu", root=sys.argv[1],
                  bench_path=bench)
print(json.dumps({"correct": out["correct"], "found": run.loaded_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_a_tiny_run_loads_no_jax_and_no_jax_package(root):
    import json

    for which in ("bloom", "bitset"):
        out = subprocess.run([sys.executable, "-c", _RUN_TINY, root, which], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        d = json.loads(out.stdout.strip().splitlines()[-1])
        assert d["correct"]
        assert d["found"] == []
        assert "redisson_tpu_torch" in d["tops"]  # the comparison is by whole names
        assert not set(FORBIDDEN) & set(d["tops"])


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.ROOT, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_top_imports(os.path.join(ref, f)))
            assert not tops & {"redisson_tpu_torch", "redisson_tpu", "jax", "jaxlib", "flax"}, f
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, portbench.reference.bitmaps, portbench.reference.hashing;"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(ast.literal_eval(out.stdout.strip()))
    assert not tops & {"redisson_tpu_torch", "redisson_tpu", "jax", "jaxlib", "flax"}


def test_no_harness_file_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(spec.ROOT):
        for f in files:
            if f.endswith(".py"):
                tops = set(_top_imports(os.path.join(dirpath, f)))
                assert not tops & {"jax", "jaxlib", "flax", "redisson_tpu"}, f
