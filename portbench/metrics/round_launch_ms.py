"""Fused tier: the host time a round spends enqueueing its layout
copies and kernel (the `fused-round` span's self time: its duration
less its `d2h` children), over every round of the window; None where
the run carries no spans (`portbench/spans.py`)."""

from portbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "fused-round", self_time=True)
