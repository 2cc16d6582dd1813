"""Share of the traced segment's wall time, in %, in which no operation
ran on the device: 1 - (union of the device's operation intervals) /
(segment seconds), from the profiler's trace.  None when the trace holds
no device operation."""


def read(st):
    seg = st["segment"]
    if not seg.device_events or seg.window_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
