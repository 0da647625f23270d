"""Rounds: log entries applied, summed over the replicas (rounds x
window x R), over the window's length (from its opening to the end of
its last round)."""


def read(run):
    o = run.outcome
    if o["driver"] != "rounds":
        return None
    return o["rounds"] * o["window"] * run.model.n_replicas / o["window_s"]
