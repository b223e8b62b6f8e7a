"""Snapshots of the program's own counters and phase histograms.

The program keeps labelled counters and log2 histograms in its
observability registry (``client.obs.registry``).  A snapshot copies, of
each family a metric reader names in its ``FAMILIES``, every counter's
value and every histogram's sum and count, keyed by ``(family,
labels)``, through the registry's public ``family(name).items()``.  A
per-layer metric reads the difference of two snapshots taken at the
window's ends.
"""

from __future__ import annotations


def snapshot(client, families) -> dict:
    reg = client.obs.registry
    out = {}
    for name in families:
        fam = reg.family(name)
        if fam is None:  # not registered yet: nothing counted
            continue
        for labels, child in fam.items():
            if fam.kind == "histogram":
                with child.lock:
                    out[(name, labels)] = (child.sum, child.count)
            else:
                out[(name, labels)] = child.value
    return out


def delta(before: dict, after: dict, family: str) -> dict:
    """``{labels: after - before}`` of one counter family (``labels`` a
    tuple of label values); a histogram gives ``(d_sum, d_count)``."""
    out = {}
    for (name, labels), v in after.items():
        if name != family:
            continue
        b = before.get((name, labels))
        if isinstance(v, tuple):
            b = b or (0.0, 0)
            out[labels] = (v[0] - b[0], v[1] - b[1])
        else:
            out[labels] = v - (b or 0.0)
    return out
