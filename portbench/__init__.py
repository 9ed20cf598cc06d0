"""portbench — the benchmark of ``pipe_tpu_torch``, the PyTorch and CUDA
port of the streaming DSP framework, on NVIDIA H100 cards.

One command runs one cell once and prints one JSON line::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout lists the cells and metrics;
everything a cell needs is found by name under this folder (:mod:`portbench.spec`).
Nothing here imports JAX or the JAX package, and the reference
(:mod:`portbench.reference`) imports nothing of the port either.
"""

import time

# the set-up time runs from here: the package is imported first by ``-m``
STARTED_WALL = time.time()
