"""ngp_map_step_mfu: the Instant-NGP mapping step's share of the card's
peak: the sum over precisions of the step's operations
(``yardstick/ngp_flops.py``, from the configuration's shapes) over that
precision's published peak, over the untraced step time of the same run."""

from benchmark.yardstick import ngp_flops, peaks


def read(record):
    if record.get("kind") != "map" or "step_s" not in record \
            or not hasattr(record.get("model"), "num_occ_bins") \
            or not record["trace"].device:
        return None
    ops = ngp_flops.map_step(record["model"], record["rays_per_batch"])
    least = sum(v / peaks.PEAK_FLOP_PER_S[k] for k, v in ops.items())
    return 100.0 * least / record["step_s"]
