"""Import-path parity of the torch port with the reference surface, the port's
mirror of ``tests/test_import_parity.py``.

The two inventories (``REFERENCE_SURFACE``: public names the reference
defines at each module path; ``DROPPED``: names deliberately left out) come
from that file with ``thermoextrap_tpu.`` mapped to
``thermoextrap_tpu_torch.``.  Beyond the reference's checks, every module
that both packages have exports each name of the JAX module's ``__all__``
(or, where the JAX module has none, each public function and class it
defines).
"""

from __future__ import annotations

import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
from _torch_parity import tt  # noqa: F401  (pins the default device to the CPU)
from test_import_parity import DROPPED, REFERENCE_SURFACE

ROOT = Path(__file__).resolve().parent.parent


def _port(name: str) -> str:
    return name.replace("thermoextrap_tpu.", "thermoextrap_tpu_torch.", 1)


PORT_SURFACE = {_port(m): names for m, names in REFERENCE_SURFACE.items()}


def _shared_modules() -> list[str]:
    """Dotted names of the JAX package's modules that the port also has."""
    jax_root = ROOT / "thermoextrap_tpu"
    out = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        if not (ROOT / "thermoextrap_tpu_torch" / rel).exists():
            continue
        parts = rel.with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(("thermoextrap_tpu", *parts)))
    return out


SHARED = _shared_modules()


@pytest.mark.parametrize("module", sorted(PORT_SURFACE))
def test_reference_names_resolve(module):
    mod = importlib.import_module(module)
    missing = [n for n in PORT_SURFACE[module] if not hasattr(mod, n)]
    assert not missing, f"{module} lacks reference names: {missing}"


def test_dropped_names_stay_dropped():
    for name, (ref_mod, _repl) in DROPPED.items():
        home = {
            "models.py": "thermoextrap_tpu_torch.models.extrap",
            "beta.py": "thermoextrap_tpu_torch.beta",
            "lnpi.py": "thermoextrap_tpu_torch.lnpi",
            "data.py": "thermoextrap_tpu_torch.data",
            "stack.py": "thermoextrap_tpu_torch.stack",
            "active_utils.py": "thermoextrap_tpu_torch.gpr_active.active_utils",
        }[ref_mod]
        assert not hasattr(importlib.import_module(home), name), (home, name)


def test_virtual_base_classes_support_isinstance():
    from thermoextrap_tpu_torch import data as d

    vals = d.factory_data_values(uv=np.arange(4.0), xv=np.arange(4.0), order=2, central=True)
    moms = d.DataCentralMoments.zeros(2)
    dvals = d.DataCentralMomentsVals.from_vals(np.arange(4.0), np.arange(4.0), 2)
    assert isinstance(vals, d.AbstractData)
    assert isinstance(moms, d.AbstractData)
    assert isinstance(dvals, d.AbstractData)
    assert isinstance(vals, d.DataValuesBase)
    assert not isinstance(moms, d.DataValuesBase)
    assert isinstance(moms, d.DataCentralMomentsBase)
    assert isinstance(dvals, d.DataCentralMomentsBase)


def test_experimental_reexports_are_lazy_but_real():
    import thermoextrap_tpu_torch.gpr_active.experimental as exp
    import thermoextrap_tpu_torch.gpr_active.gp_models as g

    assert g.HetGaussianNoiseGP is exp.HetGaussianNoiseGP
    assert g.FullyHeteroscedasticGPR is exp.FullyHeteroscedasticGPR
    assert g.HeteroscedasticGPR_analytical_scale is g.HeteroscedasticGPRAnalyticalScale
    with pytest.raises(AttributeError):
        g.not_a_reference_name  # noqa: B018


@pytest.mark.parametrize("module", SHARED)
def test_jax_module_surface_resolves_in_the_port(module):
    """Every name of the JAX module's ``__all__`` (or, without one, every
    public function and class it defines) resolves in the port's module."""
    jmod = importlib.import_module(module)
    if hasattr(jmod, "__all__"):
        names = list(jmod.__all__)
    else:
        names = [
            n
            for n, obj in vars(jmod).items()
            if not n.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module
        ]
    assert names, f"{module} has no public names to check"
    pname = _port(module + ".")[:-1]
    pmod = importlib.import_module(pname)
    missing = [n for n in names if not hasattr(pmod, n)]
    assert not missing, f"{pname} lacks {missing}"


def test_shared_modules_cover_the_port():
    """The parametrisation above sees every module but the two the port
    replaces by other files (the Pallas kernels and the XLA fallback of the
    native engine)."""
    jax_root = ROOT / "thermoextrap_tpu"
    every = {".".join(("thermoextrap_tpu", *p.relative_to(jax_root).with_suffix("").parts)).removesuffix(".__init__")
             for p in jax_root.rglob("*.py")}
    assert every - set(SHARED) == {
        "thermoextrap_tpu.ops.moments_pallas",
        "thermoextrap_tpu.native._xla_fallback",
    }
