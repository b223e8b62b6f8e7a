"""The benchmark's plain reference: Redisson's sketch semantics in plain
PyTorch, written from the algorithms and independent of the program.

- ``hashing``: MurmurHash3 x86_128 of one 16-byte block (every LongCodec
  key), the 64-bit Kirsch–Mitzenmacher pair reduced mod m, the bit
  positions ``(h1 + i*h2) mod m``, and the (m, k) sizing formulas;
- ``bitmaps``: Bloom and BitSet bitmaps built from the keys and indexes
  the benchmark generated, row comparison, and the servers that stand in
  for the program in a control run.

Nothing here imports ``jax``, ``redisson_tpu`` or ``redisson_tpu_torch``,
and nothing takes a table, a row or a hash that the program made.
"""
