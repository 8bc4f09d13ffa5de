"""portbench: the benchmark of the PyTorch/CUDA port.

One run of one cell::

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, cell, window driver or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives (see ``portbench/README.md``).  The yardstick
lives here too: traffic generation (``gen/``), the plain reference that
decides ``correct`` (``reference/``), the roofline work counts and the
card's peaks (``work/``) and the reduction of the profiler's trace
(``trace.py``).  Of the program the benchmark takes only the system under
test (``dat_replication_protocol_tpu_torch``), its spans, counters and
kernel names; ``reference/``, ``gen/`` and ``work/`` import nothing of it.
"""
