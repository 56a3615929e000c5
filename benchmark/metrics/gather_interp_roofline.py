"""gather_interp_roofline: the least time of the gather_interp calls of the
traced window's first steps (bytes and operations from each call's own
inputs, ``yardstick/table_bytes.py``, against the published peaks) over
their device time in the trace: the durations of the device operations
each call launched (``drivers/map.py``'s ``KERNEL_OPS``)."""

from benchmark.yardstick import peaks

KERNEL = "gather_interp"


def read(record):
    calls = record.get("calls", {}).get(KERNEL)
    if not calls:
        return None
    spent = sum(t for _, _, t in calls)
    if spent <= 0:
        return None
    bound = sum(peaks.bound_s(nbytes, ops) for nbytes, ops, _ in calls)
    return 100.0 * bound / spent
