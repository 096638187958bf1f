"""veneur_tpu_torch — the aggregation engine in PyTorch and CUDA.

The counterpart of the `veneur_tpu` package (JAX) for an NVIDIA H100:
the same DogStatsD ingest, the same sketch banks (t-digest, HLL, 2Sum
counters, seq-arbitrated gauges) and the same incremental,
double-buffered interval flush, with every TPU kernel on that path
replaced by a CUDA kernel written for Hopper (`csrc/`, bound in
`kernels/`). The package imports torch and numpy only.

Entry points: `server.Server(config, device=None)` (the local-tier
server: DogStatsD and SSF listeners, the overload defense, the interval
flush loop, sinks, self-tracing, the ops HTTP listener; `python -m
veneur_tpu_torch.cli.veneur -f config.yaml` runs it),
`models.pipeline.AggregationEngine(config, device=None)`, and on the
client side `trace` and `python -m veneur_tpu_torch.cli.emit`.
The device defaults to "cuda"; `aggregation_backend: cpu` or
device="cpu" runs on the CPU, as the tests do.
"""

__version__ = "0.1.0"
