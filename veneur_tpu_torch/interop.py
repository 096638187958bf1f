"""Bank state across the two packages.

The JAX package (`veneur_tpu`) and this one keep the same four banks
with the same leaf names, shapes and dtypes: TDigestBank, CounterBank,
GaugeBank and HLLBank. `banks_from_jax_numpy` turns the JAX package's
bank leaves, fetched to the host as numpy arrays, into this package's
banks on a torch device; `banks_to_numpy` goes back. Nothing here
imports JAX: the caller fetches the leaves (`np.asarray(leaf)`).

The leaves travel in one dict per bank kind:

    {"histo":   {"mean": f32[K, C], ..., "recip_lo": f32[K]},
     "counter": {"hi": f32[K], "lo": f32[K]},
     "gauge":   {"value": f32[K], "seq": i32[K]},
     "set":     {"registers": u8[K, m]}}
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hll import HLLBank
from .ops.scalar import CounterBank, GaugeBank
from .ops.tdigest import TDigestBank

BANK_KINDS = (("histo", TDigestBank), ("counter", CounterBank),
              ("gauge", GaugeBank), ("set", HLLBank))

_DTYPES = {"buf_n": np.int32, "seq": np.int32, "registers": np.uint8}


def _leaf_dtype(name: str):
    return _DTYPES.get(name, np.float32)


def banks_from_jax_numpy(leaves: dict, device) -> tuple:
    """(TDigestBank, CounterBank, GaugeBank, HLLBank) on `device` from
    the JAX package's bank leaves as numpy arrays. Raises on a missing
    or extra leaf, a dtype other than the bank's, or leaves of one bank
    that disagree on the slot count."""
    out = []
    for kind, cls in BANK_KINDS:
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
    banks, in the layout the JAX package's banks take."""
    return {kind: {name: getattr(bank, name).detach().cpu().numpy()
                   for name in cls._fields}
            for (kind, cls), bank in zip(BANK_KINDS, banks)}
