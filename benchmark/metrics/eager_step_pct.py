"""eager_step_pct: the share of the untraced window's train steps that the
mapping trainer ran eagerly, not by its CUDA graphs: the trainer's
``eager_steps`` counter's advance over the steps (``drivers/ngp_map.py``).
None where the trainer has no such counter."""


def read(record):
    eager, steps = record.get("eager_steps"), record.get("window_steps")
    if eager is None or not steps:
        return None
    return 100.0 * eager / steps
