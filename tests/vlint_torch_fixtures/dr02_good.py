"""DR02 good fixture: bank leaves become bytes only through the records
codecs; plain bytes() of a small header is no leaf byte move."""

from veneur_tpu_torch.durability import records


def serialize(engine_idx, kind, slot_ids, leaves):
    return records.encode_engine_bank(engine_idx, kind, slot_ids, leaves)


def header(x):
    return bytes(x)
