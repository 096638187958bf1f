"""DR02 fixture: raw bank-leaf byte moves in an engine-scoped module
that bypass the durability/records.py codecs. Suppressed moves with a
documented reason must stay silent."""

import numpy as np


def sneaky_serialize(bank):
    return bank.mean.tobytes()            # DR02: leaf bytes outside records


def sneaky_deserialize(data):
    return np.frombuffer(data, np.float32)   # DR02: raw decode


def documented_escape(registers):
    # vlint: disable=DR02 reason=fixture-only wire row of u8 registers,
    # exact either way; not an engine-state codec
    return registers.tobytes()


def fine_plain_bytes(x):
    return bytes(x)                       # not a leaf byte move
