"""The byte and operation counts behind ``kernel_roofline``, against counts
made by hand from the algorithms."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.peaks import peaks_for


def _space(config):
    cfg = spec.config(config)
    return spec.kind(cfg["kind"]).Space(cfg, 0), spec.kind(cfg["kind"])


@pytest.mark.parametrize("config,op,nbytes", [
    # 8 B key + k=7 words of 4 B read (+ 7 written for an add) + 1 bit
    ("bloom-1k-tenants", "contains", 8 + 28 + 0.125),
    ("bloom-1k-tenants", "add", 8 + 56 + 0.125),
    # k = 5 for tryInit(55M, 0.03)
    ("bloom-55m-replicated", "contains", 8 + 20 + 0.125),
    # 4 B index + a 4 B word read (+ written for a set) + 1 bit
    ("bitset-1gbit", "get", 4 + 4 + 0.125),
    ("bitset-1gbit", "set", 4 + 8 + 0.125),
])
def test_element_bytes(config, op, nbytes):
    space, kind = _space(config)
    assert kind.element_bytes(space, op) == nbytes


def test_element_ops_and_the_bound_that_binds():
    space, kind = _space("bloom-1k-tenants")
    assert kind.element_ops(space, "contains") == 92 + 2 + 3 * 7
    p = peaks_for("NVIDIA H100 80GB HBM3")
    # Bytes bind for every kind the benchmark has.
    for config, op in (("bloom-1k-tenants", "contains"), ("bitset-1gbit", "set")):
        space, kind = _space(config)
        assert (kind.element_bytes(space, op) / p["hbm_bytes_per_s"]
                > kind.element_ops(space, op) / p["int32_ops_per_s"])


def test_bloom_sizes_are_the_documented_ones():
    assert (_space("bloom-1k-tenants")[0].m, _space("bloom-1k-tenants")[0].k) == (9_585_059, 7)
    assert (_space("bloom-55m-replicated")[0].m,
            _space("bloom-55m-replicated")[0].k) == (401_414_247, 5)
