"""Metric readers. Each metric of BENCHMARK.json has a file
portbench/metrics/<name>.json that names its reader (a module here) and
the reader's parameters; `read(spec, run)` returns the metric's value
from what the run recorded (portbench/run.py `Run`), or None where the
run holds nothing for it to read, and the harness then leaves the metric
out of the result line."""
