"""Nested dicts of tensors as the reference's pytrees: leaves in JAX's
flattening order (dict keys sorted), each named by its ``/``-joined keys,
as ``repro/checkpoint/checkpoint.py`` names them ("opt/m/layers/attn/wq/w").
"""

from __future__ import annotations


def leaf_paths(tree, prefix: str = ""):
    """[(path, leaf)] in the reference's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def leaves(tree):
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally structured trees, called in
    :func:`leaf_paths` order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def unflatten(like, values):
    """A tree of ``like``'s structure whose leaves are ``values``, in
    :func:`leaf_paths` order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
