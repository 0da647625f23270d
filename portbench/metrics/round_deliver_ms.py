"""Wrapper: the host time a round spends handing its responses out to
the callers' sinks and taking them back (the `deliver` spans), over
every round of the window; None where the run carries no spans
(`portbench/spans.py`)."""

from portbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "deliver")
