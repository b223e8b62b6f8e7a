"""Deployment kinds: one module per kind of Redisson object the benchmark
drives (``bloom``, ``bitset``), found by the ``kind`` a configuration
file names.  A kind module gives:

- ``Space(config, seed)``: the objects (``names``, ``n_targets``) and the
  element sources a mix may draw from (``domain``, ``values``);
- ``client_config(rt, config, device)``: the program's ``Config``;
- ``ProgramApi(client, space)`` and ``ServerApi(space, device, variant)``:
  the program, or the reference in its place (a control run), behind the
  same calls (``setup``, ``issue``, ``rows``: each object's row, then its
  replicas' rows);
- ``check(space, plans, records, rows, device)``: the numbers compared,
  each ``(value, limit)``;
- ``element_bytes(space, op)`` and ``element_ops(space, op)``: the bytes
  and integer operations one element needs by the algorithm.
"""

import io
import struct

import numpy as np


def dumped_row(handle) -> np.ndarray:
    """An object's row, as the program's public ``dump()`` (Redis's DUMP)
    gives it: ``RTPU | u32 header length | JSON header | .npy row`` of
    uint32 words, read after every call answered before it."""
    data = handle.dump()
    if data[:4] != b"RTPU":
        raise ValueError(f"{handle.get_name()}: not a card engine's dump")
    (hlen,) = struct.unpack("<I", data[4:8])
    return np.load(io.BytesIO(data[8 + hlen:]), allow_pickle=False)


def replica_rows(client, name: str) -> list:
    """Each read replica's row of ``name``.  No public call reads a replica
    (reads are routed to any copy), so this one reaches into the program's
    engine: the only read-back that does."""
    eng = client._engine
    e = eng.registry.lookup(name)
    return [np.asarray(eng.executor.read_row(e.pool, r))
            for r in (e.replica_rows or ()) if r is not None and r != e.row]
