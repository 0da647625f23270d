"""The benchmark of `node_replication_torch` on an NVIDIA H100.

One command runs one cell of `BENCHMARK.json` once and prints its
result as the last line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. A cell names a configuration
(`configs/<name>.json`, whose `model` key names the adapter in
`models/<model>.py`: the program's fleet and its plain reference) and
a traffic mix (`traffic/<name>.json`, read by the one generator in
`traffic.py`, whose `driver` key names the loop in
`drivers/<driver>.py`). Each metric is read by `metrics/<name>.py`.
A new cell or metric adds files; it edits none.

Nothing here imports `jax` or the JAX package: `run.py` checks the
process's modules by their top-level names once the window has closed.
"""
