"""``pytree_dataclass``, ``replace`` and ``asdict`` of the torch port
(``thermoextrap_tpu_torch/utils/trees.py``), the port's mirror of
``tests/test_trees.py``: tensor fields are leaves of ``tree_flatten`` and
``meta_fields`` are static, a subclass is made a pytree dataclass on
definition, instances are frozen, ``replace`` keeps the type, re-decorating a
subclass with other ``meta_fields`` raises, and ``asdict`` is the shallow
field dict.  The alias subclasses of ``data`` and the factory's result as a
tree are held by ``tests/test_torch_checkpoint.py``; the JAX case of a
``jax.jit`` boundary has no counterpart.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import tt

from thermoextrap_tpu_torch import utils
from thermoextrap_tpu_torch.utils.trees import asdict, pytree_dataclass, replace, tree_flatten, tree_unflatten


def _leaves(x):
    return tree_flatten(x)[0]


def test_utils_exports_the_helpers():
    assert utils.pytree_dataclass is pytree_dataclass
    assert utils.replace is replace
    assert utils.asdict is asdict


def test_subclass_hook_registers_new_fields_as_data():
    @pytree_dataclass(meta_fields=("tag",))
    class Base:
        a: torch.Tensor
        tag: str

    class Child(Base):
        b: torch.Tensor

    c = Child(a=torch.ones(3), tag="t", b=torch.zeros(2))
    leaves, treedef = tree_flatten(c)
    assert len(leaves) == 2  # a and b are data; tag is static
    doubled = tree_unflatten(treedef, [2 * x for x in leaves])
    assert type(doubled) is Child and doubled.tag == "t"
    np.testing.assert_array_equal(doubled.a.numpy(), 2 * np.ones(3))
    np.testing.assert_array_equal(doubled.b.numpy(), np.zeros(2))
    assert Child.__tree_meta__ == ("tag",)

    # replace() works through the inherited dataclass machinery
    r = replace(c, tag="u")
    assert r.tag == "u" and type(r) is Child

    # frozen-ness is inherited by the auto-registered subclass
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.a = torch.zeros(3)


def test_redecorated_subclass_same_meta_is_idempotent():
    @pytree_dataclass(meta_fields=("tag",))
    class Base2:
        a: torch.Tensor
        tag: str

    @pytree_dataclass(meta_fields=("tag",))
    class Child2(Base2):
        pass

    c = Child2(a=torch.ones(2), tag="t")
    assert len(_leaves(c)) == 1

    with pytest.raises(TypeError, match="meta_fields"):

        @pytree_dataclass(meta_fields=())
        class Child3(Base2):
            pass


def test_plain_decorator_and_asdict():
    @pytree_dataclass
    class Pair:
        x: torch.Tensor
        y: float

    p = Pair(torch.arange(3.0), 2.5)
    assert Pair.__tree_meta__ == ()
    assert len(_leaves(p)) == 2  # a Python number is a leaf too
    d = asdict(p)
    assert list(d) == ["x", "y"] and d["x"] is p.x and d["y"] == 2.5
    assert type(replace(p, y=1.0)) is Pair
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.y = 0.0


def test_replace_on_a_data_container_keeps_type_and_meta():
    from thermoextrap_tpu_torch.data import DataCentralMoments

    d = DataCentralMoments.from_vals(tt(np.arange(6.0)), tt(np.arange(6.0) ** 2), 2)
    r = replace(d, order=1)
    assert type(r) is DataCentralMoments and r.order == 1 and r.xave is d.xave
    assert set(asdict(d)) == {f.name for f in dataclasses.fields(d)}
