"""Checkpoints of the torch port (``utils/checkpoint.py`` on ``utils/trees.py``),
mirroring ``tests/test_checkpoint.py`` (moment-state round trip, streaming
resume, the async saver) and the cases of ``tests/test_trees.py`` that apply
to the port's dataclasses (alias subclasses flatten like their base, the
factory's result is a tree, a subclass's new fields are leaves).  The
sharded case waits for the port's sharding.

Restored tensors are the saved ones bit for bit, and a resumed stream equals
the uninterrupted one exactly (the same merges in the same order); the JAX
package's resumed stream is the reference at rtol 1e-10 (float64 on both
sides, its merge order differs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch.data import DataCentralMoments, DataCentralMomentsVals, DataValues, DataValuesCentral
from thermoextrap_tpu_torch.utils import checkpoint as ck
from thermoextrap_tpu_torch.utils import trees

FIELDS = ("xave", "uave", "du", "dxdu", "wsum")


def test_moment_state_roundtrip(tmp_path, rng_np):
    uv = rng_np.normal(3.0, 1.0, 500)
    xv = rng_np.normal(1.0, 0.5, (500, 2))
    state = DataCentralMoments.from_vals(tt(xv), tt(uv), 4)
    ck.save_pytree(tmp_path / "state", state)
    out = ck.restore_pytree(tmp_path / "state", DataCentralMoments.zeros(4, val_shape=(2,), device="cpu"))
    assert out.order == state.order and out.central == state.central and type(out) is DataCentralMoments
    for k in FIELDS:
        assert torch.equal(getattr(out, k), getattr(state, k))
    # the template decides dtype and device; a mismatched template is refused
    like32 = DataCentralMoments.zeros(4, val_shape=(2,), dtype=torch.float32, device="cpu")
    assert ck.restore_pytree(tmp_path / "state", like32).dxdu.dtype == torch.float32
    with pytest.raises(ValueError, match="template"):
        ck.restore_pytree(tmp_path / "state", DataCentralMoments.zeros(4, val_shape=(3,), device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore_pytree(tmp_path / "state", (state, state))
    with pytest.raises(FileExistsError):
        ck.save_pytree(tmp_path / "state", state, force=False)


def test_streaming_resume_matches_uninterrupted_and_jax(tmp_path, rng_np):
    uv = rng_np.normal(3.0, 1.0, 600)
    xv = rng_np.normal(1.0, 0.5, 600)
    state0, update, predict = tpipe.make_streaming_extrap_pipeline(3, 1.0, device="cpu")
    chunks = [(uv[i * 200 : (i + 1) * 200], xv[i * 200 : (i + 1) * 200]) for i in range(3)]
    full = state0
    for c in chunks:
        full = update(full, *c)
    ck.save_pytree(tmp_path / "mid", update(state0, *chunks[0]))
    resumed = ck.restore_pytree(tmp_path / "mid", state0)
    for c in chunks[1:]:
        resumed = update(resumed, *c)
    betas = np.array([0.8, 1.2])
    assert torch.equal(predict(resumed, betas), predict(full, betas))
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, dtype=jnp.float64)
    for c in chunks:
        jstate = jupdate(jstate, *c)
    assert_close(predict(resumed, betas), np.asarray(jpredict(jstate, betas)), 1e-10)


def test_streaming_interp_replicates_resume_with_their_chunk_counter(tmp_path, rng_np):
    """A streaming-interpolation state with replicates is a tuple of
    ``(mean, rep, step)`` per state; the restored ``step`` keeps the chunk
    seeds, so the resumed replicates equal the uninterrupted ones exactly,
    where a counter reset to 0 redraws the first chunks' counts."""
    data = [(rng_np.normal(4.0, 1.0, 900), rng_np.normal(1.0, 0.3, (900, 1))) for _ in range(2)]
    states0, update, predict = tpipe.make_streaming_interp_pipeline(2, (0.8, 1.2), val_shape=(1,), nrep=6, seed=3, device="cpu")

    def feed(states, ks):
        for k in ks:
            for i, (u, x) in enumerate(data):
                states = update(states, i, u[k * 300 : (k + 1) * 300], x[k * 300 : (k + 1) * 300])
        return states

    full = feed(states0, range(3))
    ck.save_pytree(tmp_path / "interp", feed(states0, range(1)))
    restored = ck.restore_pytree(tmp_path / "interp", states0)
    assert [s[2] for s in restored] == [1, 1] and isinstance(restored[0][2], int)
    resumed = feed(restored, range(1, 3))
    betas = np.array([0.9, 1.1])
    for a, b in zip(predict(resumed, betas), predict(full, betas)):
        assert torch.equal(a, b)
    reset = tuple((m, r, 0) for m, r, _ in restored)
    assert not torch.equal(predict(feed(reset, range(1, 3)), betas)[1], predict(full, betas)[1])


def test_async_saver_serializes_and_waits(tmp_path, rng_np):
    uv = rng_np.normal(3.0, 1.0, 300)
    xv = rng_np.normal(1.0, 0.5, 300)
    state = DataCentralMoments.from_vals(tt(xv[:, None]), tt(uv), 3)
    with ck.AsyncPytreeSaver() as saver:
        saver.save(tmp_path / "s1", state)
        saver.save(tmp_path / "s2", state)  # written after s1
        saver.wait()
        like = DataCentralMoments.zeros(3, val_shape=(1,), device="cpu")
        for p in ("s1", "s2"):
            assert torch.equal(ck.restore_pytree(tmp_path / p, like).dxdu, state.dxdu)
        saver.save(tmp_path / "s1", state, force=False)
        with pytest.raises(FileExistsError):
            saver.wait()


# -- tests/test_trees.py -----------------------------------------------------------------------


def test_alias_subclasses_flatten_like_base(rng_np):
    uv = rng_np.normal(3.0, 1.0, 50)
    xv = rng_np.normal(1.0, 0.5, (50, 2))
    base = DataValues.from_vals(tt(xv), tt(uv), 2)
    for cls in (DataValuesCentral, DataCentralMomentsVals):
        d = cls.from_vals(tt(xv), tt(uv), 2)
        leaves, treedef = trees.tree_flatten(d)
        assert len(leaves) == len(trees.tree_flatten(base)[0]) >= 2
        back = trees.tree_unflatten(treedef, leaves)
        assert type(back) is cls and back.central == d.central
        np.testing.assert_array_equal(npy(back.uv), uv)


def test_factory_central_result_is_a_tree(rng_np):
    d = tx.factory_data_values(uv=rng_np.normal(3.0, 1.0, 40), xv=rng_np.normal(1.0, 0.5, (40, 1)), order=2, central=True)
    leaves, treedef = trees.tree_flatten(d)
    doubled = trees.tree_unflatten(treedef, [2 * a for a in leaves])
    assert type(doubled) is DataValuesCentral and doubled.order == 2
    np.testing.assert_allclose(float(doubled.uv.sum()), 2 * float(d.uv.sum()))


def test_subclass_new_fields_are_leaves():
    @dataclasses.dataclass(frozen=True)
    class Base:
        __tree_meta__ = ("tag",)
        a: torch.Tensor
        tag: str

    @dataclasses.dataclass(frozen=True)
    class Child(Base):
        b: torch.Tensor

    c = Child(a=torch.ones(3), tag="t", b=torch.zeros(2))
    leaves, treedef = trees.tree_flatten(c)
    assert len(leaves) == 2  # a and b; tag is static
    doubled = trees.tree_unflatten(treedef, [2 * x for x in leaves])
    assert type(doubled) is Child and doubled.tag == "t"
    assert torch.equal(doubled.b, torch.zeros(2))
    r = dataclasses.replace(c, tag="u")
    assert r.tag == "u" and type(r) is Child
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.a = torch.zeros(3)
    # containers, None and numbers
    tree = {"x": [torch.ones(2), None, 3], "y": (1.5,)}
    leaves, td = trees.tree_flatten(tree)
    assert len(leaves) == 3
    back = trees.tree_unflatten(td, leaves)
    assert back["x"][1] is None and back["x"][2] == 3 and back["y"] == (1.5,)
    with pytest.raises(ValueError, match="more leaves"):
        trees.tree_unflatten(td, [*leaves, 0])
    with pytest.raises(TypeError, match="cannot flatten"):
        trees.tree_flatten(object())
