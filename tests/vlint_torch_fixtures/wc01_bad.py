"""WC01 fixture: quantized-centroid wire spellings outside
cluster/wire.py. This docstring names centroids_q16 and
packed_centroids and must stay silent (documentation is exempt)."""

import base64
import struct


def handroll_q16_json(means, weights):
    # re-implementing the affine grid outside the codec: a second
    # scale expression is exactly the drift WC01 exists for
    lo, hi = min(means), max(means)
    q = [round((m - lo) / (hi - lo) * 65535) for m in means]
    row = struct.pack("<Iff", len(q), lo, hi)
    return {"centroids_q16": base64.b64encode(row).decode()}    # WC01


def read_packed_field(td):
    return td.packed_centroids                                  # WC01


def set_packed_field(td, blob):
    td.packed_centroids = blob                                  # WC01


def documented_probe(h):
    # vlint: disable=WC01 reason=fixture-only presence probe, no
    # quantization math; wire.py owns the codec
    return "centroids_q16" in h


def unrelated(h):
    return h.get("centroids", [])
