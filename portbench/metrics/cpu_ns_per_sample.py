"""Nanoseconds of host CPU that the port's process spends in the window
for each sample the window's flushes hold: every thread's CPU from the
window's start to the call of its last flush (the pump, the readers,
torch's threads, the collector), less the harness's own thread outside
its flush_once calls, over the samples `samples_per_s` counts."""


def read(rec):
    cpu, n = rec.get("cpu"), rec.get("flush_samples")
    if not cpu or not n:
        return None
    return cpu["window_s"] * 1e9 / sum(n)
