"""The benchmark of ``realvsr_tpu_torch`` (the PyTorch / CUDA port).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel family or cell lives in a file of its own, found
by its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (which
names its driver, ``drivers/<driver>.py``), ``layer_metrics/<metric>.py``,
``roofline/<family>.py``, ``limits/<cell>.json``; the plain references are
under ``reference/``.
"""
