"""Nested dicts of tensors (parameter, optimizer and train-state trees), in
``jax.tree``'s leaf order: keys sorted at every level.  A leaf's name is
its path of keys joined by ``/`` (the checkpoints' names)."""
from __future__ import annotations


def items(tree) -> list:
    """[(name, leaf)] in jax.tree's order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        else:
            out.append(("/".join(path), t))
    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def map_named(fn, tree, _path=()):
    """``fn(name, leaf)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, _path + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(_path), tree)
