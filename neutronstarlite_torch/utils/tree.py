"""The reference's pytree order and key names, without JAX.

A checkpoint stores a tree's leaves as ``<name>.<i>`` in the order
``jax.tree.flatten`` gives them, and the reference restores by that order
alone. The port keeps its parameters in another order (``param_leaves``),
in which bn ``gamma``/``beta`` and GGCN's ``Ws``/``Wd`` swap places with
leaves of the same shape; so every checkpoint of the port goes through
this module. Nodes are those of a trainer's state:

- a dict: its keys sorted, named ``['key']``;
- a list or tuple: its items in order, named ``[i]``;
- a dataclass (the port's ``AdamState``): its fields in declaration order
  (``m``, ``v``, ``step``), named ``.field``, as JAX flattens and names a
  ``register_dataclass`` node;
- anything else (a tensor, an array, a number) is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Tuple


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    elif isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            yield f"[{i}]", item
    else:
        for f in dataclasses.fields(node):
            yield f".{f.name}", getattr(node, f.name)


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple)) or (
        dataclasses.is_dataclass(node) and not isinstance(node, type)
    )


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's leaf order; the paths are
    ``jax.tree_util.keystr``'s (``[0]['bn']['gamma']``, ``.m[1]['W']``)."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out += flatten_with_path(child, prefix + key)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(like, new_leaves: List[Any]):
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return dataclasses.replace(
            node, **{f.name: build(getattr(node, f.name)) for f in dataclasses.fields(node)}
        )

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def treedef_str(tree) -> str:
    """``str(jax.tree.flatten(tree)[1])``: the structure the reference
    writes into a checkpoint manifest."""

    def node(n) -> str:
        if not _is_node(n):
            return "*"
        if isinstance(n, dict):
            return "{" + ", ".join(f"{k!r}: {node(n[k])}" for k in sorted(n)) + "}"
        if isinstance(n, (list, tuple)):
            items = ", ".join(node(item) for item in n)
            return f"[{items}]" if isinstance(n, list) else f"({items}{',' if len(n) == 1 else ''})"
        fields = ", ".join(node(getattr(n, f.name)) for f in dataclasses.fields(n))
        return f"CustomNode({type(n).__name__}[()], [{fields}])"

    return f"PyTreeDef({node(tree)})"
