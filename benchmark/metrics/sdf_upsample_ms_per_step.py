"""sdf_upsample_ms_per_step: the SDF sampler's up-sampling device time a
step: the union of the device operations launched inside the program's
``map.sdf_upsample`` span (the stratified samples' SDF, NeuS's
up-sampling rounds, their sorts and the new samples' SDF), over the traced
window's steps, in milliseconds (``drivers/sdf_map.py``'s ``sdf``
reduction, ``yardstick/parts.py``). None where the program has no such
span."""


def read(record):
    part = (record.get("sdf") or {}).get("parts", {}).get("sdf_upsample")
    if not part or not part["launches"]:
        return None
    return 1e3 * part["device_s"] / record["trace_steps"]
