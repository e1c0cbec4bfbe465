"""snnbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One run of one cell: ``python snnbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell needs is found by the names in ``BENCHMARK.json``: a configuration is
``configs/<name>.json`` (its generator ``configs/<generator>.py``), a
traffic mix ``traffic/<name>.json``, a per-layer metric a reader
``metrics/<name>.py`` (or ``metrics/<name up to its first dot>.py``).
"""
