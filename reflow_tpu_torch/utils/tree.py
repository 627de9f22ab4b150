"""Nested parameter and state trees: dicts, lists and tuples of tensors.

The port's counterpart of the few ``jax.tree`` calls the JAX package
makes on a Map's ``params`` (a ViT's ``blocks`` is a list of dicts):
copying a tree onto a device, checking its leaves, converting it. Dicts,
lists and tuples are nodes; ``None`` is an empty node, as in JAX; any
other object is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to every leaf of ``tree`` (with the matching leaves
    of each tree in ``rest``, which must have the same structure), in a
    tree of the same structure. Raises ``ValueError`` where the
    structures differ."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree structure differs: dict keys "
                                 f"{sorted(tree)} vs {_describe(r)}")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree structure differs: a sequence of "
                                 f"{len(tree)} vs {_describe(r)}")
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _describe(x: Any) -> str:
    if isinstance(x, dict):
        return f"dict keys {sorted(x)}"
    if isinstance(x, (list, tuple)):
        return f"a sequence of {len(x)}"
    return type(x).__name__
