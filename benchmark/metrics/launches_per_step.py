"""launches_per_step: device operations (kernels, copies, sets) the
profiler saw in the traced mapping window, over its steps: the host's
dispatch, which bounds a host-bound step."""


def read(record):
    if record.get("kind") != "map" or "trace" not in record:
        return None
    tr = record["trace"]
    if not tr.device:
        return None
    return tr.count() / record["trace_steps"]
