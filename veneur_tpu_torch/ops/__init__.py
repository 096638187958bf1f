"""Batched sketch banks as tensors (t-digest, HLL, counters, gauges)."""
