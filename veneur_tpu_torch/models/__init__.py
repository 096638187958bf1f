"""The aggregation engine: key interning, staging and the flush."""
