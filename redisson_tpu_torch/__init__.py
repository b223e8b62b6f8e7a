"""redisson_tpu_torch — the PyTorch/CUDA port of ``redisson_tpu``.

Redisson's probabilistic objects over stacked multi-tenant device pools,
on an NVIDIA GPU through PyTorch, with hand-written CUDA kernels where
the JAX package has Pallas kernels.  It carries RBloomFilter
add/contains on the coalesced path, RHyperLogLog, RBitSet and
RCountMinSketch with streaming top-K, the host data grid (buckets,
counters, maps, sets, lists, sorted sets, queues, streams, geo, time
series, topics), the RESP front door and the slot-sharded cluster
(``connect_cluster``, ``cluster.ClusterSupervisor``).  It never imports ``jax`` or
``redisson_tpu``; the JAX package is the reference its tests hold it
against.  ``Config().use_host_sketch()`` runs the sketches on the host
engine instead (golden NumPy models, no device).

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

__all__ = ["Config", "connect_cluster", "create", "__version__"]


def connect_cluster(seeds, **kwargs):
    """Slot-aware cluster client: route commands across an N-node
    redisson_tpu_torch (or redisson_tpu) cluster by CRC16 keyslot, with
    scatter/gather batching and MOVED/ASK/TRYAGAIN redirect handling.
    ``seeds`` is [(host, port), ...] of any subset of the nodes.

    Imports only the wire-client tier — a pure routing process never
    pays for the engine modules or torch."""
    from redisson_tpu_torch.cluster.client import ClusterClient

    return ClusterClient(seeds, **kwargs)


def create(config=None):
    """Create a client — the analog of ``Redisson.create(Config)``.
    With no config, ``Config().use_gpu_sketch()`` (the CUDA device)."""
    from redisson_tpu_torch.client import RedissonTorchClient

    return RedissonTorchClient(config or Config().use_gpu_sketch())
