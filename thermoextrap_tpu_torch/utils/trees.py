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

:func:`pytree_dataclass` makes such a dataclass (frozen, with
``__tree_meta__`` set), and :func:`replace` / :func:`asdict` are the JAX
package's helpers of the same names.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, NamedTuple, TypeVar

import torch

__all__ = ["TreeDef", "asdict", "pytree_dataclass", "replace", "tree_flatten", "tree_unflatten"]

T = TypeVar("T")

# class -> the meta_fields it was made with; a subclass is made on definition,
# so decorating it again is the same split (a no-op) or an error
_REGISTERED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pytree_dataclass(cls: type[T] | None = None, *, meta_fields: tuple[str, ...] = ()):
    """Class decorator: a frozen dataclass whose static fields are
    ``meta_fields`` (its ``__tree_meta__``); every other field is a subtree of
    :func:`tree_flatten`.

    Subclasses are made frozen dataclasses with the same static fields when
    they are defined, so an alias subclass flattens like its base.
    Decorating such a subclass again with the same ``meta_fields`` changes
    nothing; with other ``meta_fields`` it raises ``TypeError``.
    """
    meta = tuple(meta_fields)

    def register(c: type) -> None:
        prior = _REGISTERED.get(c)
        if prior is not None:
            if prior != meta:
                msg = (
                    f"{c.__name__} was already made a pytree dataclass with "
                    f"meta_fields={prior} (inherited); re-decorating a subclass "
                    f"with different meta_fields={meta} is not supported"
                )
                raise TypeError(msg)
            return
        c.__tree_meta__ = meta
        _REGISTERED[c] = meta

    def wrap(c: type[T]) -> type[T]:
        # the subclass hook below may already have made c a dataclass
        if "__dataclass_fields__" not in c.__dict__:
            c = dataclasses.dataclass(frozen=True)(c)
        register(c)

        def __init_subclass__(sub, **kwargs):
            super(c, sub).__init_subclass__(**kwargs)
            dataclasses.dataclass(frozen=True)(sub)
            register(sub)

        c.__init_subclass__ = classmethod(__init_subclass__)
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def replace(obj: T, **changes: Any) -> T:
    """``dataclasses.replace`` for the port's dataclasses."""
    return dataclasses.replace(obj, **changes)


def asdict(obj: Any) -> dict[str, Any]:
    """Shallow dict of a dataclass's fields."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


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

