"""RObject layer: the sketch objects of this package's slice, backed by
``objects/engines.TorchSketchEngine``."""

from redisson_tpu_torch.objects.bitset import BitSet
from redisson_tpu_torch.objects.bloom_filter import BloomFilter
from redisson_tpu_torch.objects.count_min_sketch import CountMinSketch
from redisson_tpu_torch.objects.hyperloglog import HyperLogLog

__all__ = ["BitSet", "BloomFilter", "CountMinSketch", "HyperLogLog"]
