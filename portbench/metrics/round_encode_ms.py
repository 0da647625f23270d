"""Wrapper: the host time a round spends encoding its op tuples into
int32 arrays and copying them to the card (the `encode` spans), over
every round of the window; None where the run carries no spans
(`portbench/spans.py`)."""

from portbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "encode")
