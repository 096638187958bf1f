"""veneur_tpu_torch — the aggregation engine in PyTorch and CUDA.

The counterpart of the `veneur_tpu` package (JAX) for an NVIDIA H100:
the same DogStatsD ingest, the same sketch banks (t-digest, HLL, 2Sum
counters, seq-arbitrated gauges) and the same incremental,
double-buffered interval flush, with every TPU kernel on that path
replaced by a CUDA kernel written for Hopper (`csrc/`, bound in
`kernels/`). The package imports torch and numpy only.

Entry point: `models.pipeline.AggregationEngine(config, device=None)`;
the device defaults to "cuda", and tests pass device="cpu".
"""
