"""DR01 good fixture: durable writes through the journal; reads and
read-only descriptors are unrestricted."""

import os


def checkpoint(journal, payload: bytes):
    journal.snapshot(payload)


def append(journal, payload: bytes):
    journal.append(payload)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def fsync_dir(path):
    fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
