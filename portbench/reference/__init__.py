"""The plain reference: NumPy re-aggregation of what the generators sent,
and the judge that holds the port's flushed rows to it. Imports nothing
of veneur_tpu_torch, veneur_tpu or JAX."""
