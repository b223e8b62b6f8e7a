"""RedissonTorchClient — the entry-point facade of the port's slice.

Parity with ``redisson_tpu/client.py`` for the sketch objects this
package carries: ``get_bloom_filter``, ``get_count_min_sketch``,
``collect`` and ``shutdown``.
"""

from __future__ import annotations

from redisson_tpu_torch.config import Config
from redisson_tpu_torch.objects import BloomFilter, CountMinSketch
from redisson_tpu_torch.objects.base import CamelCompatMixin
from redisson_tpu_torch.objects.engines import TorchSketchEngine


class RedissonTorchClient(CamelCompatMixin):
    def __init__(self, config: Config):
        if not config.gpu_sketch.enabled:
            raise ValueError(
                "redisson_tpu_torch runs sketches on the torch backend only: "
                "call Config().use_gpu_sketch()"
            )
        self.config = config
        self._engine = TorchSketchEngine(config)

    def get_bloom_filter(self, name: str) -> BloomFilter:
        return BloomFilter(name, self)

    def get_count_min_sketch(self, name: str) -> CountMinSketch:
        return CountMinSketch(name, self)

    def collect(self, futures) -> list:
        """Resolve a group of issued async results with one reply flush:
        device results of one shape come home in one D2H."""
        futures = list(futures)
        self._engine.collect_results(futures)
        return [f.result() for f in futures]

    def shutdown(self) -> None:
        """→ Redisson#shutdown."""
        self._engine.shutdown()
