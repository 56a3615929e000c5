"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates without
sparsity, at the full 700 W power limit).

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S`` and ``BF16_FLOP_PER_S``,
chip_smoke.py:135-136; ``F32_FLOP_PER_S``, chip_smoke.py:167).
"""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

PEAK_FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": F32_FLOP_PER_S}


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the float32 operations over the float32 peak (the
    table kernels compute in float32; chip_smoke.py ``bound``,
    chip_smoke.py:434-437, in seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
