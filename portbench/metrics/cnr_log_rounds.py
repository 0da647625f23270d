"""Wrapper, CNR: the per-log combiner rounds a batch, the
`cnr.combine.rounds` counter over the window's batches (one round a
log the batch maps to); None where the program has no such counter or
the fleet is not a CNR one."""


def read(run):
    o = run.outcome
    n = (run.registry or {}).get("cnr.combine.rounds")
    if o["driver"] != "rounds" or not n or not o["rounds"]:
        return None
    return n / o["rounds"]
