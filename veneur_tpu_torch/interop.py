"""Bank state across the two packages.

The JAX package (`veneur_tpu`) and this one keep the same four banks
with the same leaf names, shapes and dtypes: a histogram bank
(TDigestBank or REQBank), CounterBank, GaugeBank and a set bank (HLLBank
or ULLBank), the pair chosen by the engines' `histogram_backend` /
`set_backend`. `banks_from_jax_numpy` turns the JAX package's bank
leaves, fetched to the host as numpy arrays, into this package's banks
on a torch device; `banks_to_numpy` goes back. Nothing here imports JAX:
the caller fetches the leaves (`np.asarray(leaf)`).

The leaves travel in one dict per bank kind:

    {"histo":   {"mean": f32[K, C], ..., "recip_lo": f32[K]},
     "counter": {"hi": f32[K], "lo": f32[K]},
     "gauge":   {"value": f32[K], "seq": i32[K]},
     "set":     {"registers": u8[K, m]}}

(for REQ, "histo" holds value/weight f32[K, T], n i32[K, L], ncomp
i32[K] and the scalar leaves).
"""

from __future__ import annotations

import numpy as np
import torch

# vlint: disable=SK01 reason=a codec of bank state for every backend
# pair: it names each bank's leaves and runs no sketch math
from .ops import hll, tdigest
from .ops.scalar import CounterBank, GaugeBank
# vlint: disable=SK01 reason=the same codec, for the REQ and ULL banks
from .sketches import req, ull

KIND_NAMES = ("histo", "counter", "gauge", "set")
_HISTO_BANKS = {"tdigest": tdigest.TDigestBank, "req": req.REQBank}
_SET_BANKS = {"hll": hll.HLLBank, "ull": ull.ULLBank}

_DTYPES = {"buf_n": np.int32, "seq": np.int32, "registers": np.uint8,
           "n": np.int32, "ncomp": np.int32}


def _leaf_dtype(name: str):
    return _DTYPES.get(name, np.float32)


def banks_from_jax_numpy(leaves: dict, device,
                         histogram_backend: str = "tdigest",
                         set_backend: str = "hll") -> tuple:
    """(histogram, counter, gauge, set) banks of the engine pair on
    `device` from the JAX package's bank leaves as numpy arrays. Raises
    on a missing or extra leaf, a dtype other than the bank's, or leaves
    of one bank that disagree on the slot count."""
    classes = (_HISTO_BANKS[histogram_backend], CounterBank, GaugeBank,
               _SET_BANKS[set_backend])
    out = []
    for kind, cls in zip(KIND_NAMES, classes):
        given = leaves[kind]
        if set(given) != set(cls._fields):
            raise ValueError(f"{kind} bank leaves {sorted(given)} != "
                             f"{sorted(cls._fields)}")
        tensors = {}
        for name in cls._fields:
            a = np.asarray(given[name])
            if a.dtype != _leaf_dtype(name):
                raise ValueError(f"{kind}.{name}: dtype {a.dtype}, "
                                 f"expected {np.dtype(_leaf_dtype(name))}")
            tensors[name] = torch.tensor(a, device=device)
        slots = {t.shape[0] for t in tensors.values()}
        if len(slots) != 1:
            raise ValueError(f"{kind} bank leaves disagree on the slot "
                             f"count: {sorted(slots)}")
        out.append(cls(**tensors))
    return tuple(out)


def banks_to_numpy(banks) -> dict:
    """The inverse: {kind: {leaf: numpy array}} from this package's four
    banks (any engine pair), in the layout the JAX package's banks
    take."""
    return {kind: {name: leaf.detach().cpu().numpy()
                   for name, leaf in bank._asdict().items()}
            for kind, bank in zip(KIND_NAMES, banks)}
