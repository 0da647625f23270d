"""Minimal tree helpers over the port's state containers.

The reference's states are JAX pytrees; the port's are dicts (and
NamedTuples) of tensors. Dicts flatten in sorted-key order, as
`jax.tree` flattens them, so "the first leaf" means the same leaf in
both packages (`fault/inject.py:corrupt_states` relies on it).
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """Leaves of `tree`, dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """A tree shaped like `template` whose leaves are `leaves`, taken in
    `tree_leaves` order (dicts in sorted-key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
