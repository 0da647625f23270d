"""Kernels: K1's (`hashmap_round_kernel`) share of its roofline over
the traced window's rounds, from the bytes the rounds' work needs
(`roofline.py`), not the bytes the kernel moves."""

from portbench.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "hashmap_round_kernel", "k1_roofline")
