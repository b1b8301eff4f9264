"""The benchmark of the PyTorch and CUDA port of the LiDAR crowd-analytics
engine: ``Pipeline.analyze`` timed end to end on one card.

    python3 -m crowdbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything here is the yardstick: the venue generator (a frozen copy of
the port's ``synthetic.scaled_venue``), the traffic orders, the plain
PyTorch reference and the comparison that decides ``correct``, the work
counts and peaks of the rooflines, and the readers of the per-layer
metrics. ``BENCHMARK.json`` at the root of the repository names the cells;
each configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), kind of call (``kinds/<kind>.py``: what one
call is, its pool, reference and comparison) and per-layer metric
(``metrics/<name>.py``) is a file of its own, found by name.

Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""

import time

# ``setup_s`` is counted from here: the package is imported first when a
# run starts as ``python3 -m crowdbench.run``.
START = time.perf_counter()
