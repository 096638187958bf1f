"""Host-side helpers (hashing)."""
