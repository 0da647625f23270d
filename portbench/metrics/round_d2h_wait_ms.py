"""Wrapper: the host time a round spends blocked on the card's
device-to-host reads (the `d2h` spans: the log's free space, its tail,
the cursor check, the responses), over every round of the window; None
where the run carries no spans (`portbench/spans.py`)."""

from portbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "d2h")
