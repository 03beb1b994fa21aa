"""Nested parameter trees: dicts, lists and tuples of leaves.

The JAX package walks its parameter pytrees with ``jax.tree_util``; the
port's trees are plain containers, walked here in the same order (dict keys
sorted), so that a flat list of leaves, such as an optimizer's per-parameter
state, lines up between the two packages.  Unlike a JAX pytree, ``None`` is
a leaf here, so that a tree of gradients with holes still lines up with its
tree of parameters.
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_leaves_with_paths", "tree_map"]


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in order; ``is_leaf(x)`` true stops the walk
    at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    kids = _children(tree)
    if kids is None:
        return [tree]
    out = []
    for kid in kids:
        out.extend(tree_leaves(kid, is_leaf))
    return out


def tree_leaves_with_paths(tree, is_leaf=None, prefix: str = "") -> list:
    """(dotted path, leaf) of each leaf in ``tree_leaves``'s order: dict
    keys and list indices joined by dots, as the JAX package names a leaf
    of its parameter pytrees."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves_with_paths(v, is_leaf, f"{prefix}{k}."))
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """A tree of ``tree``'s structure with ``fn(leaf, *others)`` at every
    leaf, ``others`` the leaves at the same place in the ``rest`` trees."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
