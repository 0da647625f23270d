"""Wrapper: the program's device-to-host reads a round, the
`nr.d2h.reads` counter over the window's rounds; None where the
program has no such counter."""


def read(run):
    o = run.outcome
    n = (run.registry or {}).get("nr.d2h.reads")
    if o["driver"] != "rounds" or not n or not o["rounds"]:
        return None
    return n / o["rounds"]
