"""WC01 good fixture: q16 centroids through the wire codec. This
docstring names centroids_q16 and packed_centroids freely."""

from veneur_tpu_torch.cluster import wire


def encode(means, weights):
    return wire.encode_q16_centroids(means, weights)


def unrelated(h):
    return h.get("centroids", [])
