"""Flatten and rebuild the port's states as a list of leaves and a structure.

A state is any nesting of tuples, lists, dicts and the port's frozen
dataclasses (``DataCentralMoments``, ``DataValues`` and their alias
subclasses) whose leaves are tensors and Python numbers; ``None`` is an empty
subtree.  A dataclass names its static fields in ``__tree_meta__``, looked up
through its classes, so a subclass flattens like its base; every other field
is a subtree (its tensors are leaves).  The structure keeps the static fields
and the types, so :func:`tree_unflatten` rebuilds the state from new leaves,
as :mod:`.checkpoint` does on restore.  Python numbers are leaves: a
streaming state ``(mean, rep, step)`` keeps its chunk counter ``step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten"]


class TreeDef(NamedTuple):
    """One node of a state's structure: ``kind`` is ``"leaf"``, ``"none"``,
    ``"tuple"``, ``"list"``, ``"dict"`` or ``"dataclass"``; ``node`` holds
    the dict's keys or ``(class, static fields, data field names)``."""

    kind: str
    node: Any
    children: tuple


_LEAF = TreeDef("leaf", None, ())
_NONE = TreeDef("none", None, ())


def _meta_fields(cls) -> tuple[str, ...]:
    """The static fields of a dataclass: ``__tree_meta__`` of its nearest
    class that names one, else none."""
    for c in cls.__mro__:
        if "__tree_meta__" in c.__dict__:
            return tuple(c.__dict__["__tree_meta__"])
    return ()


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` of ``tree``, leaves in a fixed depth-first order."""
    leaves: list = []

    def walk(x) -> TreeDef:
        if x is None:
            return _NONE
        if isinstance(x, (torch.Tensor, int, float, complex)):  # bool is an int
            leaves.append(x)
            return _LEAF
        if isinstance(x, (tuple, list)):
            return TreeDef(type(x).__name__, None, tuple(walk(c) for c in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return TreeDef("dict", keys, tuple(walk(x[k]) for k in keys))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            static = _meta_fields(type(x))
            names = tuple(f.name for f in dataclasses.fields(x) if f.name not in static)
            meta = {k: getattr(x, k) for k in static}
            return TreeDef("dataclass", (type(x), meta, names), tuple(walk(getattr(x, n)) for n in names))
        msg = f"cannot flatten a {type(x).__name__}: not a tensor, number, tuple, list, dict or dataclass"
        raise TypeError(msg)

    return leaves, walk(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The state of structure ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t: TreeDef):
        if t.kind == "leaf":
            return next(it)
        if t.kind == "none":
            return None
        children = [build(c) for c in t.children]
        if t.kind == "tuple":
            return tuple(children)
        if t.kind == "list":
            return children
        if t.kind == "dict":
            return dict(zip(t.node, children))
        cls, meta, names = t.node
        return cls(**dict(zip(names, children)), **meta)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        msg = "more leaves than the structure holds"
        raise ValueError(msg)
    return out

