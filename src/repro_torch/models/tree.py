"""Trees of tensors: dicts, tuples and lists of leaves, flattened in the
reference's order (`jax.tree.leaves`: dict keys sorted, sequences in
order, `None` an empty subtree).  A model (`LM`) stands for its
parameter tree (`LM.tree()`)."""
from __future__ import annotations

from typing import Any, Callable


def as_tree(tree):
    """An `LM` as its parameter tree; any other tree as it is."""
    return tree.tree() if hasattr(tree, "tree") else tree


def leaves(tree) -> list:
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    if tree is None:
        return []
    return [tree]


def unflatten(like, flat) -> Any:
    """A tree of `like`'s structure (an `LM` becomes its tree's) with the
    leaves `flat`, in `leaves(like)`'s order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return tuple(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(as_tree(like))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (an `LM`: its tree), and of trees
    of its structure in `rest`; dicts keep `tree`'s key order, lists
    become tuples."""
    if rest:
        cols = [leaves(tree)] + [leaves(t) for t in rest]
        if any(len(c) != len(cols[0]) for c in cols):
            raise ValueError("trees of different structures")
        return unflatten(tree, [fn(*ls) for ls in zip(*cols)])
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)
