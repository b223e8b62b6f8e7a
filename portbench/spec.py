"""Everything the harness runs is found by name under one root:

- ``workloads/<cell>.json``: the cell's ``config``, ``traffic``, ``chips``
  and ``why`` (as its entry in ``BENCHMARK.json`` has them);
- ``configs/<config>.json``: the deployment (``kind``, sizes, ``source``,
  ``assumed``, ``reduced``, ``guarantees``);
- ``kinds/<kind>.py``: the code that drives and checks that kind of object;
- ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
- ``loops/<loop>.py``: how a mix's clients pace their calls, by the
  ``loop`` the mix names;
- ``metrics/<metric>.py``: a metric's reader, with its ``UNIT``, ``LAYER``
  and ``MOVES``.  A metric ``<base>.<suffix>`` with no file of its own is
  the reader ``<base>`` read as a per-layer metric of some cells: its
  module's ``PER_CELL`` gives that form's ``LAYER`` and ``MOVES``.

Which metrics a cell reports comes from ``BENCHMARK.json``: every
end-to-end and per-layer entry whose ``workloads`` list names the cell,
or that has no such list.  So a cell, a deployment, a mix or a metric is
added by new files and new entries, and no file here is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(root: str, folder: str, name: str) -> dict:
    path = os.path.join(root, folder, _name(name) + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def _module(root: str, folder: str, name: str):
    path = os.path.join(root, folder, _name(name) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: str = ROOT) -> dict:
    c = _json(root, "workloads", name)
    c["name"] = name
    return c


def config(name: str, root: str = ROOT) -> dict:
    c = _json(root, "configs", name)
    c["name"] = name
    return c


def mix_path(name: str, root: str = ROOT) -> str:
    path = os.path.join(root, "traffic", _name(name) + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no traffic named {name!r} ({path})")
    return path


def kind(name: str, root: str = ROOT):
    return _module(root, "kinds", name)


def loop(name: str, root: str = ROOT):
    return _module(root, "loops", name)


def metric(name: str, root: str = ROOT):
    base = _name(name).split(".")[0]
    if base == name or os.path.isfile(os.path.join(root, "metrics", name + ".py")):
        return _module(root, "metrics", name)
    mod = _module(root, "metrics", base)
    if not hasattr(mod, "PER_CELL"):
        raise FileNotFoundError(f"no metric named {name!r}, and {base!r} has no PER_CELL form")
    return types.SimpleNamespace(UNIT=mod.UNIT, read=mod.read, **{
        k.upper(): v for k, v in mod.PER_CELL.items()})


def cell_metrics(bench: dict, cell_name: str, section: str) -> list:
    """Entries of ``bench[section]`` that the cell reports."""
    return [m for m in bench.get(section, [])
            if "workloads" not in m or cell_name in m["workloads"]]


def load_benchmark(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
