"""The benchmark of khipu_tpu_torch on one NVIDIA card.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``T0`` is read before anything else is imported, so that ``setup_s``
starts as close to the process's start as Python allows.
"""

import time

T0 = time.perf_counter()
