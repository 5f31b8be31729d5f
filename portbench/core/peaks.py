"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), the yardstick of every roofline share here."""

HBM_BYTES_PER_S = 3.35e12
# 32-bit integer add, subtract, absolute difference, multiply-add:
# 64 results per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide), 132 SMs at 1.98 GHz
INT32_INSTR_PER_S = 132 * 64 * 1.98e9


def bound_s(nbytes: float, instr: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the integer instructions over the SMs' rate."""
    return max(nbytes / HBM_BYTES_PER_S, instr / INT32_INSTR_PER_S)
