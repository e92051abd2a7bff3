"""device_idle_pct.mixed: 100 minus the device's busy time in the profiled
calls over the wall of the same calls unprofiled, percent."""

from hvq_bench import readers


def read(rec):
    return readers.device_idle_pct(rec)
