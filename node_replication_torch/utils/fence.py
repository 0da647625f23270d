"""A real device barrier for timed regions.

CUDA launches return before the device finishes, so a timed region
that ends without a barrier measures the enqueue. `fence` synchronizes
every CUDA device holding one of the given tensors and then reads back
one scalar that depends on every tensor (one element of each folded
together), so the barrier holds even where a synchronize alone would
not: the value cannot be on the host until the work producing it ran.
CPU tensors need no barrier; the readback is then a plain read.
"""

from __future__ import annotations

import torch

from node_replication_torch.utils.tree import tree_leaves


def fence(*trees) -> None:
    """Block until every computation producing the given trees of
    tensors has really finished on its device."""
    leaves = [
        leaf
        for tree in trees
        for leaf in tree_leaves(tree)
        # size-0 leaves carry no pending data (and cannot be indexed)
        if isinstance(leaf, torch.Tensor) and leaf.numel()
    ]
    if not leaves:
        return
    by_dev: dict = {}
    for leaf in leaves:
        v = leaf.reshape(-1)[:1].to(torch.float32)
        by_dev[leaf.device] = v if leaf.device not in by_dev \
            else by_dev[leaf.device] + v
    for dev, acc in by_dev.items():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        acc.item()  # the one data-dependent readback per device
