"""Rounds: the 99th percentile (nearest rank) of one
`execute_mut_batch` call's host wall, from the call to its answers on
the host, over every round of the window."""

from portbench.harness import quantile


def read(run):
    o = run.outcome
    if o["driver"] != "rounds" or not o["round_wall_s"]:
        return None
    return quantile(o["round_wall_s"], 0.99) * 1e3
