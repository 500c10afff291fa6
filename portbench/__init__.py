"""The port's benchmark (``python3 portbench/run.py``): one cell of
``BENCHMARK.json`` a run, driven by the files its names point at."""
