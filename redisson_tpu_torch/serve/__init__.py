"""Serving: the RESP front door (``resp.RespServer``), its reactor event
loops, the native wire codec, the client-side wire helpers, the
RTopic -> CountMinSketch ingest bridge (``ingest.TopicCmsBridge``), the
engine's metrics and profiler (``metrics``) and the device nodes with
their failure monitor (``nodes``).  Boot a standalone server with
``python -m redisson_tpu_torch``.

The JAX package's per-core front door (``serve/multicore.py``) is not
ported yet.
"""

from redisson_tpu_torch.serve.ingest import TopicCmsBridge
from redisson_tpu_torch.serve.resp import RespServer

__all__ = ["RespServer", "TopicCmsBridge"]
