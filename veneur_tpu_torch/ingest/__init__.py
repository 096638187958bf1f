"""Ingest layer: the DogStatsD parser."""
