"""Carry sketch state between the JAX package and this one.

Whole objects and whole keyspaces cross with the RObject lifecycle, whose
byte formats the two packages share: ``obj.dump()`` bytes of either
package ``restore()`` in the other, and a directory written by either
``client.snapshot()`` restores in the other (``Config.snapshot_dir``, or
``engine.restore_snapshot``).  ``load_sketch_rows`` installs a single raw
row: a tenant row's uint32 words out of the JAX executor
(``state_to_host(pool)[row*u:(row+1)*u]``) go into an object of the same
geometry here.
"""

from __future__ import annotations

import numpy as np

from redisson_tpu_torch.tenancy import PoolKind
from redisson_tpu_torch.tenancy.registry import class_words_for_bits, spec_for


def load_sketch_rows(client, name: str, kind: str, params: dict, row: np.ndarray):
    """Create ``name`` as a ``kind`` sketch ("bloom", "hll", "bitset" or
    "cms") with the JAX object's ``params`` (its ``engine.params(name)``)
    and install the row: uint32 words, or 16384 uint8 registers for
    "hll".  Returns the object handle; raises if ``name`` exists or the
    row does not match the geometry."""
    engine = client._engine
    if kind == PoolKind.BLOOM:
        class_key = (class_words_for_bits(int(params["size"])),)
        handle = client.get_bloom_filter(name)
    elif kind == PoolKind.HLL:
        class_key = ()
        handle = client.get_hyper_log_log(name)
    elif kind == PoolKind.BITSET:
        # The JAX row may sit in a class above its logical length (BITOP
        # grows its operands' placement only), so the row's own width
        # counts too.
        class_key = (class_words_for_bits(max(int(params["nbits"]), 32 * len(row))),)
        handle = client.get_bit_set(name)
    elif kind == PoolKind.CMS:
        class_key = (int(params["depth"]), int(params["width"]))
        handle = client.get_count_min_sketch(name)
    else:
        raise ValueError(f"unsupported sketch kind: {kind}")
    spec = spec_for(kind, class_key)
    row = np.asarray(row, spec.dtype)
    units = spec.row_units
    if row.shape != (units,):
        raise ValueError(
            f"row of {row.shape} words; {kind} {params} rows hold {units}"
        )
    with engine._journal_gate:
        entry, created = engine.registry.try_create(name, kind, class_key, params)
        if not created:
            raise ValueError(f"object {name!r} already exists")
        if entry.row < 0:  # born cold past the device-row budget
            engine._install_residency_mirror(entry, row=row)
        else:
            engine.executor.write_row(entry.pool, entry.row, row)
        engine.nearcache.drop_object(name)
    return handle
