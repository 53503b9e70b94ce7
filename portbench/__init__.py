"""The benchmark of ``enlsip_tpu_torch``, the PyTorch and CUDA port of
ENLSIP.

Run one cell of ``BENCHMARK.json`` from the repository root:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by the names in ``BENCHMARK.json``: its
configuration in ``configs/<config>.json`` and ``configs/<config>.py``,
the plain reference of that configuration in ``reference/<config>.py``,
its traffic in ``traffic/<traffic>.json``, the limits its answers are
held to in ``reference/limits/<workload>.json`` and each per-layer metric's
reader in ``metrics/<metric>.py``.
"""
