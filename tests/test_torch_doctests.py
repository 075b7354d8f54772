"""Every docstring example of the torch port runs, the port's counterpart of
``tests/test_doctests.py::test_docstring_examples_run``.

The walk covers ``thermoextrap_tpu_torch`` and every module below it, on the
CPU (``_torch_parity`` sets the default device, so the docstrings make their
tensors there without saying so).  The gate holds the count reached: the
examples of the JAX package's docstrings (series algebra, data factories,
the beta model, the pipelines, the ideal gas, the export module) each have
their port form, with the port's outputs.
"""

import doctest
import importlib
import pkgutil

from _torch_parity import tt  # noqa: F401  (pins the default device to the CPU)

import thermoextrap_tpu_torch

# examples run (those marked +SKIP are not counted), and the JAX package's floor
N_EXAMPLES = 92
REFERENCE_FLOOR = 10


def _iter_modules():
    yield thermoextrap_tpu_torch
    for info in pkgutil.walk_packages(thermoextrap_tpu_torch.__path__, "thermoextrap_tpu_torch."):
        yield importlib.import_module(info.name)


def test_docstring_examples_run():
    flags = doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    attempted = 0
    failures = []
    for mod in _iter_modules():
        r = doctest.testmod(mod, optionflags=flags, verbose=False)
        attempted += r.attempted
        if r.failed:
            failures.append((mod.__name__, r.failed))
    assert not failures, f"doctest failures: {failures}"
    assert attempted >= max(N_EXAMPLES, REFERENCE_FLOOR), f"only {attempted} doctest examples found"
