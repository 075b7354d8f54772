"""Checkpoints of any state: a moment state, a streaming state with its
replicates and chunk counter, a tuple of states.

:func:`save_pytree` writes the leaves of a state (:mod:`.trees`) to one file
in a checkpoint directory with :func:`torch.save`, as CPU tensors and Python
numbers; :func:`restore_pytree` reads them back with ``weights_only=True``
and rebuilds the state on the structure of a template ``like``, each tensor
taking its dtype and device from the template's leaf (a state saved from the
card restores onto the CPU, or back onto the card, by the template alone).
The static fields (moment order, flags, callbacks) come from the template.
A streaming state's chunk counter is a leaf and is restored: the replicate
counts of later chunks derive from it.  A sharded leaf (a ``DTensor``) is
saved whole (its ``full_tensor()``, gathered on every rank and written by
rank 0 alone) and restored with the template's mesh and placements.
:class:`AsyncPytreeSaver` writes on a worker thread.  The single-file ``.npz`` checkpoint of one moment state is
:meth:`..data.DataCentralMoments.save`.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import torch
import torch.distributed as dist

from .device import is_dtensor
from .trees import tree_flatten, tree_unflatten

__all__ = ["AsyncPytreeSaver", "restore_pytree", "save_pytree"]

_FILE = "leaves.pt"


def _snapshot(tree) -> tuple[list, bool]:
    """The leaves of ``tree`` as CPU copies (tensors, a ``DTensor`` whole)
    and numbers, and whether any leaf was sharded (then every rank of its
    mesh must take part)."""
    leaves, _ = tree_flatten(tree)
    sharded = any(is_dtensor(x) for x in leaves)
    out = [
        (x.full_tensor() if is_dtensor(x) else x).detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
        for x in leaves
    ]
    return out, sharded


def _writes(sharded: bool) -> bool:
    """Whether this process writes: always, except that the leaves of a
    sharded state are written by rank 0 alone."""
    return not sharded or dist.get_rank() == 0


def _write(path, leaves: list, force: bool) -> None:
    path = os.path.abspath(str(path))
    target = os.path.join(path, _FILE)
    if os.path.exists(target) and not force:
        msg = f"a checkpoint exists at {path}; pass force=True to overwrite it"
        raise FileExistsError(msg)
    os.makedirs(path, exist_ok=True)
    tmp = target + ".tmp"
    torch.save(leaves, tmp)
    os.replace(tmp, target)  # a reader sees the old checkpoint or the new one


def save_pytree(path, tree, *, force: bool = True) -> None:
    """Checkpoint the leaves of ``tree`` to the directory ``path`` (created).
    ``force=True`` overwrites an existing checkpoint there.  A state with
    ``DTensor`` leaves is saved by a call on every rank (a collective): rank
    0 writes, and every rank returns once the file is there."""
    leaves, sharded = _snapshot(tree)
    try:
        if _writes(sharded):
            _write(path, leaves, force)
    finally:
        if sharded:
            dist.barrier()


def restore_pytree(path, like):
    """Restore a checkpoint of :func:`save_pytree` on the structure of
    ``like``, a state of the same structure and shapes (for example a
    pipeline's ``state0``).  Each tensor takes the dtype and device of
    ``like``'s leaf, each number the type of ``like``'s; a ``DTensor`` leaf
    of ``like`` gives a ``DTensor`` on its mesh with its placements (a
    collective: every rank restores)."""
    leaves = torch.load(os.path.join(os.path.abspath(str(path)), _FILE), weights_only=True)
    like_leaves, treedef = tree_flatten(like)
    if len(leaves) != len(like_leaves):
        msg = f"the checkpoint holds {len(leaves)} leaves, the template {len(like_leaves)}"
        raise ValueError(msg)
    out = []
    for i, (x, ref) in enumerate(zip(leaves, like_leaves)):
        if isinstance(ref, torch.Tensor):
            if not isinstance(x, torch.Tensor) or x.shape != ref.shape:
                shape = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
                msg = f"leaf {i}: checkpoint {shape} against template {tuple(ref.shape)}"
                raise ValueError(msg)
            if is_dtensor(ref):
                from torch.distributed.tensor import distribute_tensor

                x = x.to(dtype=ref.dtype, device=ref.to_local().device)
                out.append(distribute_tensor(x, ref.device_mesh, ref.placements))
            else:
                out.append(x.to(dtype=ref.dtype, device=ref.device))
        else:
            out.append(type(ref)(x))
    return tree_unflatten(treedef, out)


class AsyncPytreeSaver:
    """Checkpoint writer on a worker thread: :meth:`save` returns once the
    leaves are copied to host memory, and the file is written behind it, so
    a streaming producer keeps ingesting (a ``DTensor`` leaf is gathered
    in :meth:`save` on every rank, and rank 0 alone writes).  Saves of one
    saver are written in the order issued; :meth:`wait` blocks until all are on disk (and
    raises the first error, if any); :meth:`close` waits and ends the worker.
    Usable as a context manager."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    def save(self, path, tree, *, force: bool = True) -> None:
        leaves, sharded = _snapshot(tree)
        if _writes(sharded):
            self._pending.append(self._pool.submit(_write, path, leaves, force))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
