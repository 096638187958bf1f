"""DR01 fixture: raw file writes in a durability-scoped module that
bypass the Journal append/snapshot API. Reads and suppressed writes
must stay silent."""

import os
from pathlib import Path


def sneaky_checkpoint(path, payload: bytes):
    with open(path, "wb") as f:          # DR01: unframed write
        f.write(payload)


def sneaky_append(path, payload: bytes):
    fd = os.open(path, os.O_WRONLY)      # DR01: raw fd
    os.write(fd, payload)                # DR01: unframed bytes
    os.close(fd)


def sneaky_path_write(path, payload: bytes):
    Path(path).write_bytes(payload)      # DR01: bypasses the journal


def fine_read(path):
    with open(path, "rb") as f:          # reads are fine
        return f.read()


def fine_readonly_fd(path):
    # read-only os.open (the dir-fsync pattern) is fine too
    fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
    os.close(fd)
    return fd


def documented_escape(path):
    # vlint: disable=DR01 reason=fixture-only marker file, not durable
    # state; nothing recovers from it
    with open(path, "w") as f:
        f.write("marker")


def sneaky_variable_mode(path, mode):
    return open(path, mode)              # DR01: unresolvable mode
