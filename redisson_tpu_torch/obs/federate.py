"""Metrics federation — one merged Prometheus exposition over a fleet of
per-node ``/metrics`` endpoints, every sample relabeled with a
``node="host:port"`` dimension; the port's copy of
``redisson_tpu/obs/federate.py``.

Two deployment forms share this module:

- ``python -m redisson_tpu_torch --frontdoor-processes K --metrics-port
  N`` — the per-core front door's parent serves its workers' endpoints
  merged on N (each worker serves its own on N+1+i);
- ``python -m redisson_tpu_torch --federate host:port,... --metrics-port
  N`` — a standalone federation-only process (no engine, no RESP door).

Scrapes happen per request (the promhttp discipline: no background
collection thread); an unreachable node contributes
``rtpu_federation_node_up{node=...} 0`` instead of failing the whole
exposition.  Families are regrouped so each name renders ONE
``# TYPE`` block with all nodes' samples under it — duplicate TYPE
lines are a Prometheus parse error, not a cosmetic issue.
"""

from __future__ import annotations

import threading
import urllib.request

from redisson_tpu_torch.obs.promhttp import MetricsHTTPServer


def _inject_node_label(sample_line: str, node: str) -> str:
    """``name{a="b"} v`` → ``name{node="X",a="b"} v`` (node first so a
    reader scanning the merged page sees the owner immediately)."""
    esc = node.replace("\\", "\\\\").replace('"', '\\"')
    brace = sample_line.find("{")
    space = sample_line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        return (
            sample_line[: brace + 1]
            + f'node="{esc}",'
            + sample_line[brace + 1:]
        )
    if space == -1:
        return sample_line  # malformed; pass through untouched
    return (
        sample_line[:space] + f'{{node="{esc}"}}' + sample_line[space:]
    )


def merge_expositions(pages: "list[tuple[str, str]]") -> str:
    """Merge ``[(node_label, exposition_text)]`` into one valid page:
    per family, one HELP/TYPE (first seen) followed by every node's
    samples with the ``node`` label injected."""
    order: list = []  # family names in first-seen order
    meta: dict = {}   # family -> [comment lines]
    samples: dict = {}  # family -> [relabeled sample lines]
    for node, text in pages:
        family = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                # "# TYPE name kind" / "# HELP name text"
                if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                    family = parts[2]
                    if family not in meta:
                        meta[family] = []
                        samples[family] = []
                        order.append(family)
                    if line not in meta[family]:
                        # First node's wording wins; identical repeats
                        # (every node shares the codebase) dedupe here.
                        kind = parts[1]
                        if not any(
                            m.split(None, 2)[1] == kind
                            for m in meta[family]
                        ):
                            meta[family].append(line)
                continue
            if family is None:
                # Untyped sample (no preceding TYPE): its own family
                # keyed by the bare metric name.
                name = line.split("{", 1)[0].split(" ", 1)[0]
                family = name
                if family not in meta:
                    meta[family] = []
                    samples[family] = []
                    order.append(family)
            samples[family].append(_inject_node_label(line, node))
    out: list = []
    for fam in order:
        out.extend(meta[fam])
        out.extend(samples[fam])
    return "\n".join(out) + "\n"


class FederatedMetrics:
    """Scrape-and-merge renderer over N member ``/metrics`` targets."""

    def __init__(self, targets, timeout_s: float = 2.0):
        # targets: iterable of "host:port" strings or (host, port).
        self.targets = [
            t if isinstance(t, str) else "%s:%d" % tuple(t)
            for t in targets
        ]
        if not self.targets:
            raise ValueError("federation needs at least one target")
        self.timeout_s = timeout_s

    def _scrape(self, target: str) -> "tuple[str, str]":
        url = f"http://{target}/metrics"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return target, r.read().decode("utf-8", "replace")

    def render(self) -> str:
        pages: list = []
        up_lines = [
            "# HELP rtpu_federation_node_up member endpoint reachable "
            "at this scrape",
            "# TYPE rtpu_federation_node_up gauge",
        ]
        # Scrape members concurrently: a slow/unreachable node must not
        # serialize the whole fleet page behind its timeout.
        results: dict = {}

        def one(t):
            try:
                results[t] = self._scrape(t)[1]
            except Exception as e:
                results[t] = e

        threads = [
            threading.Thread(target=one, args=(t,), daemon=True)
            for t in self.targets
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(self.timeout_s + 1.0)
        for t in self.targets:
            got = results.get(t)
            esc = t.replace("\\", "\\\\").replace('"', '\\"')
            if isinstance(got, str):
                pages.append((t, got))
                up_lines.append(f'rtpu_federation_node_up{{node="{esc}"}} 1')
            else:
                up_lines.append(f'rtpu_federation_node_up{{node="{esc}"}} 0')
        return merge_expositions(pages) + "\n".join(up_lines) + "\n"


def start_federation_endpoint(targets, host: str = "127.0.0.1",
                              port: int = 0, timeout_s: float = 2.0
                              ) -> MetricsHTTPServer:
    """Serve the merged fleet exposition at ``/metrics`` — the
    ``--federate`` mode of the metrics endpoint."""
    fm = FederatedMetrics(targets, timeout_s=timeout_s)
    srv = MetricsHTTPServer(fm.render, host=host, port=port)
    srv.federation = fm  # introspection / tests
    return srv


__all__ = [
    "FederatedMetrics",
    "merge_expositions",
    "start_federation_endpoint",
]
