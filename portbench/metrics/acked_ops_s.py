"""Served: operations whose answer reached a client by the window's
close, over the window's length."""


def read(run):
    o = run.outcome
    if o["driver"] != "served":
        return None
    return o["acked"] / o["window_s"]
