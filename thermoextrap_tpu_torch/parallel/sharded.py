r"""Sharded (co)moment reduction, bootstrap and MBAR over a device mesh.

Counterpart of ``thermoextrap_tpu/parallel/sharded.py`` on
``torch.distributed``.  The mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with the reference's axis
names: ``rec`` shards the sample axis, ``rep`` the bootstrap replicates.
Both are embarrassingly parallel, and central-moment accumulators merge
exactly, so each function reduces its rank's block and merges the tiny
partial sums with explicit ``all_reduce`` calls over the ``rec`` group.

- *Inputs.*  Every function takes a ``DTensor`` placed as it expects
  (:func:`shard_rec` places the sample axis) or a whole tensor or array,
  which it shards itself with ``distribute_tensor`` (rank 0's data).  A
  ``DTensor`` on another mesh, or placed otherwise, raises: nothing is
  resharded quietly.  The work runs on ``to_local()`` blocks, so no
  ``DTensor`` operation, and no collective of its sharding propagation, runs
  inside.
- *Exactness.*  The reference's two-pass form: one all-reduce for the global
  weighted means, then the centred (or shifted raw) sums of each block, a
  second all-reduce, and the exact recentring of
  :mod:`..ops.convert`.  Sums over the sample axis are torch's tree sums,
  and the comoment contractions matrix products over blocks of 4096 samples
  whose results are tree-summed: one float32 product over 1e7-1e8 samples
  would lose digits on the card; the batched u-moment bootstrap contracts
  its grid rows by ``einsum``, as the plain path does.
- *Uneven shards.*  ``distribute_tensor`` splits as ``torch.chunk`` does, so
  a rank may hold fewer samples than another, or none.  Every local
  reduction is defined on an empty block (a sum is 0, a log-sum-exp
  ``-inf``), so any length gives the unsharded answer; MBAR needs no padding.
- *Outputs.*  Where the reference's ``out_specs`` are ``P()``, a plain
  tensor, equal on every rank; where they keep the ``rep`` sharding, a
  ``DTensor`` sharded on ``rep`` and replicated on the other axes, whose
  ``full_tensor()`` is the global array (a plain tensor on a mesh without a
  ``rep`` axis, as the reference's ``rep_spec`` falls back to ``None``).
- *Devices.*  A ``cuda`` mesh computes on the rank's card in the inputs'
  type and its group is NCCL; a ``cpu`` mesh uses gloo.  A world of one
  rank still goes through every all-reduce.

``torch.distributed.tensor`` is imported on first use: it loads sympy and
much of torch's compiler stack.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..ops.convert import fix_central_du, fix_central_dxdu, shift_raw_comoments, shift_raw_moments
from ..utils.device import default_device, is_dtensor

__all__ = [
    "make_mesh",
    "mbar_expectations_grid_sharded",
    "mbar_solve_sharded",
    "reduce_central_comoments_sharded",
    "reduce_central_umoments_batched_sharded",
    "resample_central_comoments_sharded",
    "resample_central_umoments_batched_sharded",
    "shard_rec",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _dt():
    """``torch.distributed.tensor``, imported on first use."""
    from torch.distributed import tensor

    return tensor


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def _set_card() -> None:
    """Bind this process to its card: ``LOCAL_RANK`` when a launcher set it,
    else the rank modulo the cards."""
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        local = (dist.get_rank() if dist.is_initialized() else 0) % torch.cuda.device_count()
    torch.cuda.set_device(local)


def _init_group(backend: str) -> None:
    """The default process group: the launcher's world where ``torchrun``
    (or another launcher) set ``WORLD_SIZE`` and ``MASTER_ADDR``, else a
    world of one rank on a ``file://`` store in a temporary directory (no
    TCP port, no ``MASTER_ADDR``)."""
    try:
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
            return
        store = tempfile.mkdtemp(prefix="thermoextrap_mesh_")
        atexit.register(shutil.rmtree, store, ignore_errors=True)
        dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0, world_size=1)
    except (RuntimeError, ValueError) as err:
        msg = f"torch.distributed could not start a {backend} process group: {err}"
        raise RuntimeError(msg) from err


def _check_backend(device_type: str) -> str:
    want = _BACKENDS[device_type]
    have = str(dist.get_backend())
    if want not in have:
        msg = (
            f"a {device_type} mesh needs a {want} process group, but the default group runs {have!r} "
            "(gloo is never used for CUDA tensors)"
        )
        raise RuntimeError(msg)
    return want


def make_mesh(n_devices: int | None = None, axis_names=("rec",), device=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of
    the default process group, one device a rank.

    ``axis_names``: one axis (``("rec",)``), or two laid out by the
    reference's balanced factorization (``a x n/a`` with ``a`` the largest
    divisor of ``n`` up to ``sqrt(n)``), for example ``("rep", "rec")``.
    ``device``: ``"cuda"`` (NCCL, each rank on its card) or ``"cpu"``
    (gloo); by default the type of :func:`..utils.device.default_device`.
    ``n_devices``: the number of ranks, which must be the world's (a mesh
    spans every rank; None takes them all).

    Without a default group, one is started: the launcher's world when
    ``torchrun`` set its variables, else a world of one rank on a
    ``file://`` store; later calls reuse it.  A failed start or first
    collective raises and names the backend.
    """
    axis_names = tuple(axis_names)
    if len(axis_names) not in (1, 2) or len(set(axis_names)) != len(axis_names):
        msg = f"axis_names must be one or two distinct names, got {axis_names}"
        raise ValueError(msg)
    kind = default_device().type if device is None else torch.device(device).type
    if kind not in _BACKENDS:
        msg = f"a mesh runs on cuda or cpu devices, not {kind!r}"
        raise ValueError(msg)
    if kind == "cuda":
        if not torch.cuda.is_available():
            msg = "a cuda mesh needs a CUDA device"
            raise RuntimeError(msg)
        _set_card()
    if not dist.is_initialized():
        launched = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
        if n_devices not in (None, 1) and not launched:
            msg = (
                f"no process group: a {n_devices}-device mesh needs {n_devices} ranks "
                "(launch them with torchrun, or see parallel.dryrun), or call make_mesh(1, ...)"
            )
            raise RuntimeError(msg)
        _init_group(_BACKENDS[kind])
    backend = _check_backend(kind)
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        msg = f"a mesh spans every rank of the default group: n_devices={n_devices}, world size {n}"
        raise ValueError(msg)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(kind, shape, mesh_dim_names=axis_names)
    # the first collective brings NCCL's communicator up: fail here, by name
    probe = torch.ones(1, device=_mesh_device(mesh))
    try:
        dist.all_reduce(probe)
    except (RuntimeError, ValueError) as err:
        msg = f"the {backend} process group failed its first all_reduce: {err}"
        raise RuntimeError(msg) from err
    return mesh


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------


def _placements(mesh, dims: dict) -> tuple:
    """``Shard(d)`` on each mesh axis named in ``dims``, ``Replicate()`` on
    the others."""
    dt = _dt()
    missing = set(dims) - set(mesh.mesh_dim_names)
    if missing:
        msg = f"mesh axes {sorted(missing)} are not in the mesh's {mesh.mesh_dim_names}"
        raise ValueError(msg)
    return tuple(dt.Shard(dims[a]) if a in dims else dt.Replicate() for a in mesh.mesh_dim_names)


def _shard(arr, mesh, dims: dict, dtype=None):
    """``arr`` as a ``DTensor`` placed by ``dims``.  A ``DTensor`` must sit
    on ``mesh`` with those placements already; anything else is a whole
    array, sent to the mesh's device (cast to ``dtype`` when given) and
    split from rank 0's data."""
    want = _placements(mesh, dims)
    if is_dtensor(arr):
        if arr.device_mesh != mesh:
            msg = f"a DTensor on {arr.device_mesh} was passed with mesh={mesh}; reshard it first"
            raise ValueError(msg)
        if tuple(arr.placements) != want:
            msg = f"a DTensor placed {tuple(arr.placements)} was passed where {want} is expected"
            raise ValueError(msg)
        return arr
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr))
    arr = arr.to(device=_mesh_device(mesh), dtype=dtype)
    return _dt().distribute_tensor(arr, mesh, list(want))


def shard_rec(arr, mesh, axis_name: str = "rec"):
    """Place an array with its leading (sample) axis sharded over the mesh
    axis ``axis_name`` and replicated over the others: a ``DTensor``."""
    return _shard(arr, mesh, {axis_name: 0})


def _local(arr, mesh, dims: dict, dtype=None):
    """This rank's block of ``arr`` placed by ``dims``."""
    out = _shard(arr, mesh, dims).to_local()
    return out if dtype is None else out.to(dtype)


def _ndim(arr) -> int:
    return arr.ndim if hasattr(arr, "ndim") else np.ndim(arr)


def _shape(arr) -> tuple:
    """The global shape (a ``DTensor``'s shape is the global one)."""
    return tuple(arr.shape) if hasattr(arr, "shape") else np.shape(arr)


def _weight_local(weight, uv, u_l, mesh, dims: dict):
    """This rank's block of the sample weights, broadcast to ``uv``'s shape
    (ones when ``weight`` is None)."""
    if weight is None:
        return torch.ones_like(u_l)
    if not is_dtensor(weight):
        w = weight if isinstance(weight, torch.Tensor) else torch.as_tensor(np.asarray(weight))
        weight = torch.broadcast_to(w.to(device=u_l.device, dtype=u_l.dtype), _shape(uv)).contiguous()
    return _local(weight, mesh, dims, u_l.dtype)


def _out(local, mesh, dims: dict, shape: tuple):
    """A result sharded by ``dims`` (the replicate axis) as a ``DTensor`` of
    global ``shape``; the local tensor itself when the mesh has none of
    those axes."""
    dims = {a: d for a, d in dims.items() if a is not None and a in mesh.mesh_dim_names}
    if not dims:
        return local
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return _dt().DTensor.from_local(
        local.contiguous(), mesh, list(_placements(mesh, dims)), shape=torch.Size(shape), stride=tuple(stride)
    )


def _full(*ts) -> tuple:
    """Results as whole tensors: the ``full_tensor()`` of a ``DTensor``."""
    return tuple(t.full_tensor() if is_dtensor(t) else t for t in ts)


def _rec_map(fn, arrs, mesh, axis_name: str = "rec"):
    """``fn`` of the local sample blocks of ``arrs`` (sharded by
    :func:`shard_rec`), returned as a ``DTensor`` of the same placement:
    per-sample reshaping and packing without a ``DTensor`` operation."""
    out = fn(*(_local(a, mesh, {axis_name: 0}) for a in arrs))
    return _out(out, mesh, {axis_name: 0}, (_shape(arrs[0])[0], *out.shape[1:]))


def _all_sum(t, mesh, axis_name: str):
    """Sum ``t`` over the ranks of the mesh axis ``axis_name``; returns the
    sum (``t`` itself when it is contiguous: NCCL reduces only contiguous
    tensors, and the batched bootstrap's ``einsum`` output is not one)."""
    t = t.contiguous()
    dist.all_reduce(t, group=mesh.get_group(axis_name))
    return t


# samples contracted by one matrix product in _contract; the blocks' results
# are summed by a tree
_BLOCK = 1 << 12


def _contract(f, cols):
    """``sum_j f[p, j] cols[j, c]`` → ``(P, C)``: a batched matrix product
    over blocks of ``_BLOCK`` samples, whose ``(blocks, P, C)`` results are
    summed by torch's tree reduction, so no float32 sum runs over more than
    a block (one product over 1e7-1e8 samples loses digits on the card)."""
    r = f.shape[-1]
    main = r - r % _BLOCK
    out = f[:, main:] @ cols[main:]
    if main:
        nb = main // _BLOCK
        blocks = torch.bmm(f[:, :main].reshape(f.shape[0], nb, _BLOCK).transpose(0, 1), cols[:main].reshape(nb, _BLOCK, -1))
        out = out + blocks.sum(0)
    return out


def _u_rows(w, du, order: int):
    """``[w, w du, ..., w du^order]`` stacked on a new leading axis."""
    rows = [w]
    for _ in range(order):
        rows.append(rows[-1] * du)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# moments
# ---------------------------------------------------------------------------


def reduce_central_comoments_sharded(uv, xv, order: int, mesh, weight=None, axis_name: str = "rec", return_wsum: bool = False):
    r"""Exact central comoment reduction with the samples sharded over the
    mesh axis ``axis_name``.

    ``uv (R,)``, ``xv (R, *val)`` and ``weight`` (None, or broadcastable to
    ``uv``): whole arrays or ``DTensor``\ s placed by :func:`shard_rec`.
    Returns ``(xave (*val,), uave (), du (order+1,), dxdu (order+1,
    *val))``, plain tensors equal on every rank, with ``du[0] = 1``,
    ``du[1] = 0``, ``dxdu[0] = 0``; with ``return_wsum`` also the total
    weight.  Two all-reduces of ``O(order V)`` numbers whatever R.
    """
    dims = {axis_name: 0}
    val_shape = _shape(xv)[1:]
    u_l = _local(uv, mesh, dims)
    x_l = _local(xv, mesh, dims)
    dtype = torch.promote_types(u_l.dtype, x_l.dtype)
    u_l = u_l.to(dtype)
    x_l = x_l.to(dtype).reshape(u_l.shape[0], -1)
    w_l = _weight_local(weight, uv, u_l, mesh, dims)

    # pass 1: the exact global means
    stats = _all_sum(torch.cat([torch.stack([w_l.sum(), (w_l * u_l).sum()]), (w_l[:, None] * x_l).sum(0)]), mesh, axis_name)
    wsum = stats[0]
    ubar = stats[1] / wsum
    xbar = stats[2:] / wsum

    # pass 2: the partial sums about the global means
    p = _u_rows(w_l, u_l - ubar, order)  # (order+1, r_local)
    sums = _all_sum(torch.cat([p.sum(-1)[:, None], _contract(p, x_l - xbar)], dim=1), mesh, axis_name)
    du = fix_central_du(sums[:, 0] / wsum)
    dxdu = fix_central_dxdu(sums[:, 1:] / wsum)
    out = (xbar.reshape(val_shape), ubar, du, dxdu.reshape((order + 1, *val_shape)))
    return (*out, wsum) if return_wsum else out


def reduce_central_umoments_batched_sharded(uv, order: int, mesh, weight=None, axis_name: str = "rec", return_wsum: bool = False):
    r"""Exact batched central u-moments with the SAMPLE axis (the last of
    ``uv (*batch, R)``) sharded over ``axis_name``: the lnΠ grid and the
    ⟨u⟩ path.  Returns ``(uave (*batch,), du (order+1, *batch))`` with
    ``du[0] = 1``, ``du[1] = 0``, plain tensors equal on every rank; with
    ``return_wsum`` also the total weights ``(*batch,)``."""
    dims = {axis_name: _ndim(uv) - 1}
    u_l = _local(uv, mesh, dims)
    w_l = _weight_local(weight, uv, u_l, mesh, dims)

    stats = _all_sum(torch.stack([w_l.sum(-1), (w_l * u_l).sum(-1)]), mesh, axis_name)
    wsum = stats[0]
    ubar = stats[1] / wsum
    sums = _all_sum(_u_rows(w_l, u_l - ubar[..., None], order).sum(-1), mesh, axis_name)
    du = fix_central_du(sums / wsum)
    return (ubar, du, wsum) if return_wsum else (ubar, du)


def _rep_axis(mesh, rep_axis):
    return rep_axis if rep_axis is not None and rep_axis in mesh.mesh_dim_names else None


def _freq_dims(mesh, rec_axis: str, rep_axis, ndim: int = 2) -> dict:
    dims = {rec_axis: ndim - 1}
    rep = _rep_axis(mesh, rep_axis)
    if rep is not None:
        dims[rep] = 0
    return dims


def _safe_first(sums0):
    """The replicates' total weights with an all-zero replicate taken as 1
    (its moments become the finite stand-in of the plain path)."""
    ok = sums0 > 0
    return ok, torch.where(ok, sums0, torch.ones_like(sums0))


def resample_central_umoments_batched_sharded(
    uv, freq, order: int, mesh, weight=None, rec_axis: str = "rec", rep_axis: str | None = "rep", return_wsum: bool = False
):
    r"""Sharded batched u-moment bootstrap for grid workloads.

    ``uv (*batch, R)`` sharded over ``rec`` (its last axis); ``freq (nrep,
    R)`` sharded over ``(rep, rec)`` and SHARED across the batch axes (a
    replicate resamples whole configurations).  Returns ``(uave (nrep,
    *batch), du (order+1, nrep, *batch))``, sharded on ``rep`` when the mesh
    has that axis; with ``return_wsum`` also the replicates' total weights
    ``(nrep, *batch)``.  An all-zero replicate gives the plain path's finite
    stand-in.
    """
    nb = _ndim(uv) - 1
    batch = _shape(uv)[:-1]
    nrep = _shape(freq)[0]
    dims = {rec_axis: nb}
    u_l = _local(uv, mesh, dims)
    w_l = _weight_local(weight, uv, u_l, mesh, dims)
    f = _local(freq, mesh, _freq_dims(mesh, rec_axis, rep_axis), u_l.dtype)  # (nrep_local, r_local)

    # the global per-row means as the common shift
    stats = _all_sum(torch.stack([w_l.sum(-1), (w_l * u_l).sum(-1)]), mesh, rec_axis)
    ubar = stats[1] / stats[0]
    p = _u_rows(w_l, u_l - ubar[..., None], order)  # (order+1, *batch, r_local)
    sums = _all_sum(torch.einsum("pr,n...r->np...", f, p), mesh, rec_axis)  # (order+1, nrep_local, *batch)
    _ok, first = _safe_first(sums[0])
    m = sums / first
    uave = m[1] + ubar[None]
    du = fix_central_du(shift_raw_moments(m, m[1]))
    rep = _rep_axis(mesh, rep_axis)
    out = (_out(uave, mesh, {rep: 0}, (nrep, *batch)), _out(du, mesh, {rep: 1}, (order + 1, nrep, *batch)))
    return (*out, _out(sums[0], mesh, {rep: 0}, (nrep, *batch))) if return_wsum else out


def resample_central_comoments_sharded(
    uv, xv, freq, order: int, mesh, weight=None, rec_axis: str = "rec", rep_axis: str | None = "rep", return_wsum: bool = False
):
    r"""Sharded bootstrap: ``freq (nrep, R)`` sharded over ``(rep, rec)``,
    the samples over ``rec``; each replicate's shifted raw sums are merged
    by an all-reduce over ``rec`` and recentred exactly.

    Returns the contract of :func:`..ops.resample.resample_central_comoments`,
    ``(xave (nrep, *val), uave (nrep,), du (order+1, nrep), dxdu (order+1,
    nrep, *val))``, each sharded on ``rep`` when the mesh has that axis; with
    ``return_wsum`` also the replicates' total weights ``(nrep,)``.  An
    all-zero replicate gives the plain path's finite stand-in.
    """
    val_shape = _shape(xv)[1:]
    nrep = _shape(freq)[0]
    dims = {rec_axis: 0}
    u_l = _local(uv, mesh, dims)
    x_l = _local(xv, mesh, dims)
    dtype = torch.promote_types(u_l.dtype, x_l.dtype)
    u_l = u_l.to(dtype)
    x_l = x_l.to(dtype).reshape(u_l.shape[0], -1)
    v = x_l.shape[1]
    w_l = _weight_local(weight, uv, u_l, mesh, dims)
    f = _local(freq, mesh, _freq_dims(mesh, rec_axis, rep_axis), dtype)  # (nrep_local, r_local)

    # the global means as the common shift
    stats = _all_sum(torch.cat([torch.stack([w_l.sum(), (w_l * u_l).sum()]), (w_l[:, None] * x_l).sum(0)]), mesh, rec_axis)
    ubar = stats[1] / stats[0]
    xbar = stats[2:] / stats[0]

    p = _u_rows(w_l, u_l - ubar, order).T  # (r_local, order+1)
    xs = x_l - xbar
    contrib = torch.cat([p, *(p[:, n : n + 1] * xs for n in range(order + 1))], dim=1)
    sums = _all_sum(_contract(f, contrib), mesh, rec_axis)  # (nrep_local, (order+1)(1+V))
    ok, first = _safe_first(sums[:, 0])
    u = sums[:, : order + 1] / first[:, None]
    u = torch.cat([torch.where(ok, u[:, 0], torch.ones_like(u[:, 0]))[:, None], u[:, 1:]], dim=1)
    m = u.T  # (order+1, nrep_local): raw moments about the global means
    c = torch.movedim((sums[:, order + 1 :] / first[:, None]).reshape(-1, order + 1, v), 1, 0)  # (order+1, nrep_local, V)

    uave = m[1] + ubar
    xave = c[0] + xbar[None, :]
    du = shift_raw_moments(m, m[1])
    dxdu = fix_central_dxdu(shift_raw_comoments(c, m[1][:, None]) - c[0][None] * du[:, :, None])
    du = fix_central_du(du)
    rep = _rep_axis(mesh, rep_axis)
    nl = u.shape[0]
    out = (
        _out(xave.reshape(nl, *val_shape), mesh, {rep: 0}, (nrep, *val_shape)),
        _out(uave, mesh, {rep: 0}, (nrep,)),
        _out(du, mesh, {rep: 1}, (order + 1, nrep)),
        _out(dxdu.reshape(order + 1, nl, *val_shape), mesh, {rep: 1}, (order + 1, nrep, *val_shape)),
    )
    return (*out, _out(sums[:, 0], mesh, {rep: 0}, (nrep,))) if return_wsum else out


# ---------------------------------------------------------------------------
# sharded MBAR
# ---------------------------------------------------------------------------
#
# The MBAR solve and the expectations reduce over the sample axis only
# (models/mbar.py).  The reference lets GSPMD turn each reduction into a
# psum; here the solver's sample-axis reductions take the rec group and
# all-reduce their partial sums (a log-sum-exp as an all-reduce MAX of the
# local maxima, then an all-reduce SUM of the shifted exponentials).  Each
# Newton iteration communicates O(K + K^2) numbers whatever N, and every
# rank reads the same all-reduced residual, so all stop on one iteration.


def _mbar_inputs(u_kn, n_k, mesh, axis_name: str):
    from ..models.mbar import _tensor

    u_l = _local(u_kn, mesh, {axis_name: 1})
    log_n_k = torch.log(_tensor(n_k, u_l.device, u_l.dtype))
    return u_l, log_n_k


def mbar_solve_sharded(
    u_kn, n_k, mesh, tol: float | None = None, max_iter: int = 10000, method: str = "hybrid", axis_name: str = "rec"
):
    """:func:`..models.mbar.mbar_solve_info` with the samples (axis 1 of
    ``u_kn (K, N)``) sharded over ``axis_name``.  Returns ``(f_k, n_iter,
    residual)``: ``f_k`` and the residual as plain tensors equal on every
    rank, the iteration count as a Python int."""
    from ..models.mbar import _solve

    u_l, log_n_k = _mbar_inputs(u_kn, n_k, mesh, axis_name)
    if tol is None:
        tol = 1e-12 if u_l.dtype == torch.float64 else 1e-5
    f, it, res = _solve(u_l, log_n_k[None], None, tol, max_iter, method, group=mesh.get_group(axis_name))
    return f[0], int(it[0]), res[0]


def mbar_expectations_grid_sharded(u_kn, n_k, f_k, u_targets, x_n, mesh, axis_name: str = "rec"):
    """:func:`..models.mbar.mbar_expectations_grid` with the samples sharded:
    ``u_kn (K, N)`` and ``u_targets (A, N)`` over axis 1, ``x_n (N, V)``
    (or ``(N,)``, taken as one column) over axis 0.  The ``(A, N) @ (N, V)``
    weighted average contracts the sharded axis: one all-reduce of the
    ``(A, V)`` result.  Returns ``(A, V)``, a plain tensor equal on every
    rank."""
    from ..models.mbar import _grid_from_denom, _log_denom, _tensor

    u_l, log_n_k = _mbar_inputs(u_kn, n_k, mesh, axis_name)
    t_l = _local(u_targets, mesh, {axis_name: 1}, u_l.dtype)
    x_l = _local(x_n, mesh, {axis_name: 0}, u_l.dtype)
    if x_l.ndim == 1:
        x_l = x_l[:, None]
    f_k = _tensor(f_k, u_l.device, u_l.dtype)
    group = mesh.get_group(axis_name)
    return _grid_from_denom(_log_denom(f_k, u_l, log_n_k), t_l, x_l, None, group=group)
