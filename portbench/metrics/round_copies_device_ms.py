"""Fused tier: the device time of a round's layout copies in the
hashmap's fused engine (the `[R, K]` <-> `[Kp, R]` transposes of both
planes and of the responses), the `nr.fused.copies_device_s`
histogram's sum over its rounds, in ms; None where the program has no
such histogram."""


def read(run):
    h = (run.registry or {}).get("nr.fused.copies_device_s")
    if not h or not h.get("count"):
        return None
    return h["sum"] / h["count"] * 1e3
