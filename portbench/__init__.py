"""portbench: the benchmark of moonshine_tpu_torch on one NVIDIA H100.
`python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (run.py)."""
