"""Serving: the RESP front door (``resp.RespServer``), its reactor event
loops, the native wire codec, the client-side wire helpers, and the
RTopic -> CountMinSketch ingest bridge (``ingest.TopicCmsBridge``).  Boot
a standalone server with ``python -m redisson_tpu_torch``.

The JAX package's per-core front door (``serve/multicore.py``), device
probes (``serve/nodes.py``) and profiler metrics (``serve/metrics.py``)
are not ported yet.
"""

from redisson_tpu_torch.serve.ingest import TopicCmsBridge
from redisson_tpu_torch.serve.resp import RespServer

__all__ = ["RespServer", "TopicCmsBridge"]
