"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, no sparsity), at the full 700 W power limit. A card set below it
runs slower under load: the run prints its ``power.limit`` beside these."""

BF16_FLOPS = 989e12  # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its compute and
    its memory bound (bf16 work)."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
