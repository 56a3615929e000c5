"""idle_pct.map: the share of the traced mapping window in which nothing ran
on the card: 1 - (the union of kernel, copy and set intervals) / (the
window), from the profiler's device activity."""


def read(record):
    if record.get("kind") != "map" or "trace" not in record:
        return None
    tr = record["trace"]
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
