"""Kernels: K5's share of its roofline over the traced window's
rounds: one fused round's C call launches the decode pre-pass (with
the ring append) and the replay body, and both count as K5's time."""

from portbench.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "flat_decode_kernel", "k5_roofline",
                           also=("flat_kernel",))
