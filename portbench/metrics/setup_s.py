"""Seconds from the process's start to the window's start: imports, the
device's first use, the server's start and warm-up, the generators'
set-up and the flushes before the window."""


def read(rec):
    return rec["setup_s"]
