"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).

Every roofline and utilisation share of this benchmark divides by these:
operations by the top dense rate whatever the dtype they ran in, so that
no implementation can read over 100%, and bytes by the HBM rate."""

DENSE_FLOPS_PER_S = 989e12      # bf16 / fp16 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12       # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the operations over
    the top dense rate and the bytes over the memory rate."""
    return max(flops / DENSE_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
