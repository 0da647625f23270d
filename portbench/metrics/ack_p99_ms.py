"""Served: the 99th percentile (nearest rank) of send-to-answer time
over every operation sent in the window, an operation that never
answered counting as infinitely late."""

from portbench.harness import quantile


def read(run):
    o = run.outcome
    if o["driver"] != "served" or not o["latency_s"]:
        return None
    return quantile(o["latency_s"], 0.99) * 1e3
