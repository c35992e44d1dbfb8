"""Nested dict/list/tuple trees of tensors: flatten, unflatten and map.

The port's stand-in for ``jax.tree_util`` on the trees it uses (the LeNet
params ``{"c1": {"w", "b"}, ...}``, gradient trees, bucket round trips).
The leaf order is JAX's: dict keys sorted, lists and tuples in order, so a
flattened port tree lines up leaf for leaf with the JAX one, and ``None``
is an empty subtree as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

#: Structure of a tree with its leaves taken out: ("leaf",), ("none",),
#: ("dict", keys, children), ("list", children) or ("tuple", children).
TreeDef = Tuple


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, tuple(walk(v) for v in t))
        leaves.append(t)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_paths(tree: Any) -> List[str]:
    """'/'-joined key paths of the leaves, in flatten order (the JAX
    checkpoint format's keys)."""
    out: List[str] = []

    def walk(t, prefix):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}/")
        else:
            out.append(prefix[:-1])

    walk(tree, "")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
