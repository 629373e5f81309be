"""The port's benchmark: ``BENCHMARK.json`` at the checkout's root names its
cells, and ``python3 -m benchmark.run`` runs one (see ``benchmark/run.py``
and ``benchmark/harness.py``).  It drives ``bpt_tpu_torch`` only."""
