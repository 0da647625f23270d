"""Serve layer: the mean ops a combiner round took in the window, the
`nr.combine.batch_size` histogram's sum over its count."""


def read(run):
    h = (run.registry or {}).get("nr.combine.batch_size")
    if not h or not h.get("count"):
        return None
    return h["sum"] / h["count"]
