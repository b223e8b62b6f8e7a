"""Config for the PyTorch/CUDA port — the ``use_tpu_sketch()`` switch of
``redisson_tpu/config.py`` becomes ``use_gpu_sketch()``, with the same
names and defaults for the knobs this package reads, plus ``device``.

``device`` defaults to ``"cuda"``; construction raises when no CUDA
device is present (nothing falls back to the CPU).  Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional


class GpuSketchConfig:
    """Tunables for the GPU sketch backend."""

    def __init__(self):
        self.enabled = False
        self.device = "cuda"
        # Coalescer (CommandBatchService-role) knobs.
        self.coalesce = True  # cross-call op coalescing via a flush thread
        self.batch_window_us = 200  # flush deadline
        self.max_batch = 1 << 16  # flush size threshold
        self.min_bucket = 256  # smallest padded batch (floor 32: results travel bit-packed)
        self.max_inflight = 8  # dispatched-but-uncollected launches
        # A producer's submit() blocks once this many ops are queued ahead
        # of the flush thread.  0 -> 8 x max_batch.
        self.max_queued_ops = 0
        # The completer fetches several pending launches' results with one
        # device-side concatenation and one D2H.
        self.mailbox_collect = True
        # Exact intra-batch sequential semantics for bloom add.  False
        # selects the single-tenant bulk add whose newly-added flags are
        # taken against the state before the call (ops/fastpath.py).
        self.exact_add_semantics = True

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def update(self, d: dict) -> None:
        for k, v in d.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown gpuSketch config key: {k}")
            setattr(self, k, v)


class Config:
    """→ org/redisson/config/Config.java (the slice's part of it)."""

    def __init__(self):
        from redisson_tpu_torch.codecs import DEFAULT_CODEC

        self.codec = DEFAULT_CODEC
        self.gpu_sketch = GpuSketchConfig()
        # Snapshots (the JAX package's names and defaults): with a
        # directory set, the engine restores from it on create and writes
        # a final snapshot on shutdown; an interval > 0 adds periodic ones.
        self.snapshot_dir: Optional[str] = None
        self.snapshot_interval_s: float = 0.0

    def set_codec(self, codec) -> "Config":
        self.codec = codec
        return self

    def use_gpu_sketch(self, **kwargs) -> "Config":
        """Run sketch objects on the torch backend; ``kwargs`` set
        ``GpuSketchConfig`` knobs (``device="cpu"`` for the CPU)."""
        self.gpu_sketch.enabled = True
        self.gpu_sketch.update(kwargs)
        return self
