"""idle_routing_pct.mixed: the device's idle time in the profiled calls while the host routes,
over the profiled wall, percent. It reads the profile's 200 longest idle gaps alone, each named by
the phase open at its midpoint (search/route or routed/pack innermost); shorter gaps are not
counted, and the profiler slows the host routing it sets against the wall."""

from hvq_bench import span_readers


def read(rec):
    return span_readers.idle_routing_pct(rec)
