"""The part of ``jax.tree_util`` the training path needs: trees of tensors
(nested dicts, lists and tuples, and dataclasses that name their data
fields) flattened in JAX's order, with the reference's path strings.

JAX flattens a dict by its sorted keys, a list or tuple by index and a
registered dataclass by its data fields in registration order, and drops
``None``. The reference names a leaf by its path: dict keys and list
indices joined with "/" (``blocks/attn/wq``), a dataclass field as
``.name`` (``.m/embed``). The optimizer policies and the checkpoint
manifests are keyed by those strings, so the port must produce the same
ones in the same order.

A dataclass takes part by listing its data fields in ``PYTREE_FIELDS``;
its other fields are static metadata and are carried over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    """(path component, child) pairs of a node (see ``_is_node``), in JAX's
    order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return [(f".{f}", getattr(tree, f)) for f in tree.PYTREE_FIELDS]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and hasattr(tree, "PYTREE_FIELDS"))


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path string, leaf)] in JAX's flatten order; ``None`` is skipped."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(leaves_with_path(child, f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in flatten order, by
    ``new_leaves`` (an iterable of exactly as many values)."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _rebuild(tree, it: Iterator):
    if tree is None:
        return None
    if not _is_node(tree):
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree holds")
        return leaf
    if isinstance(tree, dict):
        # Rebuild in sorted order (the leaves' order), keep the dict's own.
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, it) for c in tree)
    return dataclasses.replace(tree, **{f: _rebuild(getattr(tree, f), it)
                                        for f in tree.PYTREE_FIELDS})


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure, flattened the same way)."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} vs {len(o)} leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
