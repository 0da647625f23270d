"""Device: the share of the traced span's device-idle time during which
no `mut-batch` span was open, the idle time the program's spans do not
explain (`portbench/spans.py:attribute_idle`); None where the run
carries no spans mapped onto the device trace."""


def read(run):
    idle = getattr(run, "idle", None)
    return None if idle is None else idle["idle_unspanned_pct"]
