"""The benchmark of the PyTorch and CUDA port (``dpvo_tpu_torch``).

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
its result as the last line of standard output. The cell's configuration,
runner, traffic and metrics are files found by name:
``configs/<config>.json``, ``runners/<runner>.py`` (the configuration's
``runner``, ``stream`` by default), ``traffic/<traffic>.json`` (read by the
generator module its ``kind`` names) and ``metrics/<metric>.py``.
``reference/`` is the plain reference that decides ``correct``; it imports
nothing of the port.
"""
