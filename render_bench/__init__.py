"""The benchmark of arctic_tpu_torch: one cell of BENCHMARK.json run once.

    python3 render_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, program entry or
metric lives in a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``entries/<entry>.py`` and ``metrics/<metric>.py``.
"""
