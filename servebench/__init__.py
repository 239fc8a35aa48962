"""servebench: the serving benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix) once:

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json`` at the repository
root. Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:
``configs/<config>.json``, ``knees/<config>.json`` (written by
``sweep.py``), ``mixes/<traffic>.json`` and ``metrics/<metric>.py``. The
yardstick (traffic generation, the FLOP and byte arithmetic, the peaks, the
plain reference in ``reference/`` and the comparison that decides
``correct``) lives here; from the program the benchmark takes only the
engine it drives, its counters and its kernel names. Nothing here imports
JAX or the JAX package.
"""
