"""The port's benchmark: ``python3 port_bench/run.py --workload <cell> ...``
(README.md)."""
