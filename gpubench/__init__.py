"""The benchmark of ``qwen3_rs_tpu_torch`` on one NVIDIA GPU.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, driver or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's published sizes and what was assumed;
* ``traffic/<traffic>.json``: the parameters of a traffic mix, read by
  ``traffic.py``; it names its driver;
* ``drivers/<driver>.py``: builds the system under test and drives it;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float | None``;
* ``checks/<cell>.json``: the limit of the comparison that decides ``correct``.

The yardstick lives here too: the frozen byte and operation counts
(``counts.py``), the card's peaks (``peaks.json``), the trace reduction
(``trace.py``), the plain reference (``reference/``) and the comparison
(``check.py``).
"""
