"""Wrapper: the mean wait of a contended acquisition of the combiner
lock in the window (`nr.lock.wait_s`); the count goes to standard
error beside it."""

from portbench.harness import log


def read(run):
    h = (run.registry or {}).get("nr.lock.wait_s")
    if not h or not h.get("count"):
        return None
    log(f"lock_wait_ms: {h['count']} contended acquisitions")
    return h["sum"] / h["count"] * 1e3
