"""Client facades over the sketch objects: the Batch (RBatch) facade."""

from redisson_tpu_torch.grid.batch import Batch, BatchFuture, BatchResult

__all__ = ["Batch", "BatchFuture", "BatchResult"]
