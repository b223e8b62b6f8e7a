"""redisson_tpu_torch — the PyTorch/CUDA port of ``redisson_tpu``.

Redisson's probabilistic objects over stacked multi-tenant device pools,
on an NVIDIA GPU through PyTorch, with hand-written CUDA kernels where
the JAX package has Pallas kernels.  It carries RBloomFilter
add/contains on the coalesced path, RHyperLogLog, RBitSet and
RCountMinSketch with streaming top-K, the host data grid (buckets,
counters, maps, sets, lists, sorted sets, queues, streams, geo, time
series, topics) and the RESP front door.  It never imports ``jax`` or
``redisson_tpu``; the JAX package is the reference its tests hold it
against.

    import redisson_tpu_torch
    client = redisson_tpu_torch.create(
        redisson_tpu_torch.Config().use_gpu_sketch())
    bf = client.get_bloom_filter("bf")
    bf.try_init(1_000_000, 0.01)
    bf.add("hello")
    assert bf.contains("hello")
"""

from redisson_tpu_torch.config import Config

__version__ = "0.1.0"

__all__ = ["Config", "create", "__version__"]


def create(config=None):
    """Create a client — the analog of ``Redisson.create(Config)``.
    With no config, ``Config().use_gpu_sketch()`` (the CUDA device)."""
    from redisson_tpu_torch.client import RedissonTorchClient

    return RedissonTorchClient(config or Config().use_gpu_sketch())
