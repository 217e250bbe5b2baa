"""The H100's peaks that a kernel's least time is measured against
(copied from ``chip_smoke.py``'s yardsticks): the SXM data sheet's memory
rate, and one instruction a lane and clock on every SM at the top clock,
~33.4e12 a second (a count of operations goes over the issue rate; the
data sheet's 67 TFLOP/s of float32 counts an FMA as two)."""

HBM_BYTES_PER_S = 3.35e12
SM_COUNT, LANES_PER_SM, BOOST_CLOCK_HZ = 132, 128, 1.98e9
ISSUE_PER_S = SM_COUNT * LANES_PER_SM * BOOST_CLOCK_HZ


def least_us(nbytes: float, ops: float) -> float:
    """The least time the card could take for a launch: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its operations over the issue rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ISSUE_PER_S) * 1e6
