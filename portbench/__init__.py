"""The port's benchmark: `python3 portbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>` runs one cell of `BENCHMARK.json` on the
card and prints its result line.  It measures `repro_torch` and imports
nothing of the JAX package."""
