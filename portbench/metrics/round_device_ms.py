"""Fused tier: all device time in the traced span of the window
(kernels, copies and sets), over the rounds in it."""


def read(run):
    s, o = run.summary, run.outcome
    if s is None or o["driver"] != "rounds" or not o["traced_rounds"]:
        return None
    return s["device_s"] / o["traced_rounds"] * 1e3
