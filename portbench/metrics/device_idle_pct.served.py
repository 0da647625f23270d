"""Device, served cells: the share of the traced window in which no
kernel, copy or set ran on the card."""

from portbench.roofline import idle_pct


def read(run):
    return idle_pct(run, "served")
