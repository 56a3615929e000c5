"""occupancy_ms_per_step: the occupancy sampler's device time a step: the
union of the device operations launched inside the program's
``map.occupancy`` (the bin lookups and the resampling) and
``map.occ_refresh`` (the grid's refresh) spans, over the traced window's
steps, in milliseconds (``drivers/ngp_map.py``'s ``occupancy`` reduction,
``yardstick/parts.py``). None where the program has no such span."""


def read(record):
    occ = record.get("occupancy")
    if not occ or not any(p["launches"] for p in occ["parts"].values()):
        return None
    spent = sum(p["device_s"] for p in occ["parts"].values())
    return 1e3 * spent / record["trace_steps"]
