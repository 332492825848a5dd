"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit), against which every roofline and mfu share is taken."""

F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
SFU_EXP_PER_SM_CLOCK = 16     # ex2 per SM and clock
SMS = 132
SM_CLOCK_HZ = 1.98e9          # the boost clock under load
EXP_PER_S = SFU_EXP_PER_SM_CLOCK * SMS * SM_CLOCK_HZ


def bound_s(flops: float, exps: float, nbytes: float) -> float:
    """The least time the chip could take for this work: the largest of
    its f32 flops, its exps and its bytes, each at its peak rate."""
    return max(flops / F32_FLOPS_PER_S, exps / EXP_PER_S,
               nbytes / HBM_BYTES_PER_S)
