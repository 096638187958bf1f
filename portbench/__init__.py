"""The benchmark of veneur_tpu_torch: one run of one cell a process.

`python -m portbench.run --workload <config>.<traffic> --seed N
--seconds S --trace 0|1` runs the cell that BENCHMARK.json names. A
configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json` (it names its generator in `gen/`), and every
metric `metrics/<metric-name>.py`; the harness finds each by its name.
Nothing here imports JAX or the JAX package, and `reference/` imports
nothing of the port.
"""
