"""Serving: the RESP front door (``resp.RespServer``), its reactor event
loops, the native wire codec and the client-side wire helpers.  Boot a
standalone server with ``python -m redisson_tpu_torch``.

The JAX package's per-core front door (``serve/multicore.py``), ingest
bridges (``serve/ingest.py``), device probes (``serve/nodes.py``) and
profiler metrics (``serve/metrics.py``) are not ported yet.
"""

from redisson_tpu_torch.serve.resp import RespServer

__all__ = ["RespServer"]
