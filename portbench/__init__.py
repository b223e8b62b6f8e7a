"""portbench: the benchmark of ``redisson_tpu_torch`` on NVIDIA cards.

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell (``portbench/run.py``).  The harness imports the
program only inside a run, and never ``jax``, ``jaxlib`` or the JAX
package ``redisson_tpu``; ``portbench/reference`` imports nothing of the
program either.
"""
