"""The native pump thread's CPU over the window, in percent of one
core (its utime + stime in /proc, read at the window's two ends)."""


def read(rec):
    cpu, w = rec.get("cpu"), rec.get("window_s")
    if not cpu or cpu.get("pump_s") is None or not w:
        return None
    return cpu["pump_s"] / w * 100
