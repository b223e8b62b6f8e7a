"""RedissonTorchClient — the entry-point facade of the port's slice.

Parity with ``redisson_tpu/client.py`` for the sketch objects this
package carries: ``get_bloom_filter``, ``get_hyper_log_log``,
``get_bit_set``, ``get_count_min_sketch``, ``create_batch``, ``collect``,
``defer_fetch``, ``snapshot`` and ``shutdown``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from redisson_tpu_torch.config import Config
from redisson_tpu_torch.grid.batch import Batch
from redisson_tpu_torch.objects import BitSet, BloomFilter, CountMinSketch, HyperLogLog
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

    def get_hyper_log_log(self, name: str) -> HyperLogLog:
        return HyperLogLog(name, self)

    def get_bit_set(self, name: str) -> BitSet:
        return BitSet(name, self)

    def get_count_min_sketch(self, name: str) -> CountMinSketch:
        return CountMinSketch(name, self)

    def create_batch(self) -> Batch:
        """→ RedissonClient#createBatch: the deferred-execution facade."""
        return Batch(self)

    def collect(self, futures) -> list:
        """Resolve a group of issued async results with one reply flush:
        device results of one shape come home in one D2H."""
        futures = list(futures)
        self._engine.collect_results(futures)
        return [f.result() for f in futures]

    def defer_fetch(self):
        """Context manager for a bulk-dispatch region whose results are
        resolved with :meth:`collect`.  The JAX package's results start an
        eager per-launch host copy that this suppresses; results here are
        fetched only on ``.result()`` or ``collect``, so it has nothing to
        suppress and is a no-op, kept for the same client code."""
        return contextlib.nullcontext()

    def snapshot(self, directory: Optional[str] = None) -> None:
        """Snapshot the whole sketch keyspace to ``directory`` (default:
        ``Config.snapshot_dir``)."""
        directory = directory or self.config.snapshot_dir
        if not directory:
            raise ValueError("no snapshot directory configured")
        os.makedirs(directory, exist_ok=True)
        self._engine.snapshot(directory)

    def shutdown(self) -> None:
        """→ Redisson#shutdown (writes the final snapshot when
        ``Config.snapshot_dir`` is set)."""
        self._engine.shutdown()
