"""The benchmark of the PyTorch and CUDA port (``epivo_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything of one configuration, traffic mix or
per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and ``limits/<cell>.json``. The yardstick (``yardstick/``: frames and
windows from the seed, the kernels' work and the card's peaks) and the
plain reference (``reference/``) import nothing of the program.
"""
