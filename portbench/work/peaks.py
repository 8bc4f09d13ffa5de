"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
power limit; a card set lower runs slower under load, so every run
prints its power limit beside the numbers.

* HBM3 bandwidth 3.35 TB/s (NVIDIA H100 Tensor Core GPU datasheet).
* INT32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73 T
  operations/s (NVIDIA Hopper architecture white paper: 64 INT32 units
  an SM); it agrees with the datasheet's 67 TFLOP/s of FP32, which is
  128 lanes x 2 FLOP at the same clock.
"""

HBM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = SM_COUNT * INT32_LANES_PER_SM * BOOST_HZ


def bound_s(nbytes: float, int_ops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the integer operations at the INT32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S)
