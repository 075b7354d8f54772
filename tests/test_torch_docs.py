"""The port's reference pages (``docs_torch/``) and the README's CPU block,
the port's counterpart of ``tests/test_doctests.py::test_api_md_covers_public_names``
and of running the pages' code.

- ``api.md`` names every entry of the port's three public ``__all__``s and
  its device functions;
- every ``python`` block of ``usage.md``, ``serving.md`` and
  ``migration.md`` runs, in order in one namespace a page, except a block
  whose preceding paragraph starts with ``*Not run:`` (which says why);
- ``examples.md`` maps each script of ``examples_torch/``;
- the README's CPU block runs as written, and its interpolation is held to
  ``idealgas.x_ave``;
- no page imports ``jax`` or the JAX package.
"""

import ast
import re
from pathlib import Path

import pytest
import torch
from _torch_parity import tt  # noqa: F401  (pins the default device to the CPU)

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import idealgas, pipeline, serving_export

ROOT = Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs_torch"
RUN_PAGES = ("usage.md", "serving.md", "migration.md")
FENCE = re.compile(r"```python\n(.*?)```", re.S)


def _python_blocks(text: str) -> list[tuple[bool, str]]:
    """``[(runs, source), ...]`` of a markdown text's ``python`` blocks."""
    out = []
    for m in FENCE.finditer(text):
        before = text[: m.start()].rstrip().split("\n\n")[-1].lstrip()
        out.append((not before.startswith("*Not run:"), m.group(1)))
    return out


def _run(source: str, ns: dict, where: str) -> list:
    """Run ``source`` one top-level statement at a time in ``ns``; returns the
    values of its expression statements."""
    values = []
    for stmt in ast.parse(source).body:
        if isinstance(stmt, ast.Expr):
            values.append(eval(compile(ast.Expression(stmt.value), where, "eval"), ns))
        else:
            exec(compile(ast.Module([stmt], type_ignores=[]), where, "exec"), ns)
    return values


def test_api_md_names_the_public_surface():
    text = (DOCS / "api.md").read_text()
    names = [
        *xt.__all__,
        *pipeline.__all__,
        *serving_export.__all__,
        "default_device",
        "set_default_device",
    ]
    missing = [n for n in names if not re.search(rf"\b{re.escape(n)}\b", text)]
    assert not missing, f"docs_torch/api.md does not name {missing}"


@pytest.mark.parametrize("page", RUN_PAGES)
def test_page_blocks_run(page, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    blocks = _python_blocks((DOCS / page).read_text())
    runs = [src for ok, src in blocks if ok]
    assert runs, f"{page} has no block that runs"
    ns: dict = {"__name__": f"docs_torch.{page}"}
    for i, src in enumerate(runs):
        _run(src, ns, f"{page} block {i}")


def test_not_run_blocks_say_why():
    for page in RUN_PAGES:
        text = (DOCS / page).read_text()
        skipped = [src for ok, src in _python_blocks(text) if not ok]
        said = text.count("*Not run:")
        assert said == len(skipped), f"{page}: {said} *Not run* lines, {len(skipped)} blocks not run"


def test_examples_md_maps_every_example_script():
    text = (DOCS / "examples.md").read_text()
    scripts = sorted(p.name for p in (ROOT / "examples_torch").glob("*.py") if not p.name.startswith("_"))
    assert len(scripts) == 13
    missing = [s for s in scripts if f"examples_torch/{s}" not in text]
    assert not missing, f"docs_torch/examples.md does not map {missing}"


def test_readme_cpu_block_runs_and_interpolates():
    text = (ROOT / "README.md").read_text()
    blocks = [src for _, src in _python_blocks(text) if 'xt.set_default_device("cpu")' in src]
    assert len(blocks) == 1, "README.md should hold one CPU block of the port"
    ns: dict = {}
    try:
        *_, pred, std = _run(blocks[0], ns, "README.md CPU block")
    finally:
        xt.set_default_device("cpu")
    betas = torch.linspace(1.0, 5.0, 9, dtype=torch.float64)
    assert isinstance(pred, torch.Tensor) and pred.device.type == "cpu" and pred.dtype == torch.float64
    assert tuple(pred.shape) == (9,)
    # the joint order-6 polynomial over [1, 5] from 2000 configurations a
    # state, within 4 sigma of x_ave at each beta (sigma: 50 replicates)
    err = (pred - idealgas.x_ave(betas)).abs()
    sigma = ns["interp"].resample({"nrep": 50, "rng": 7}).predict(betas).std(dim=1)
    assert bool((err <= 4.0 * sigma).all()), (err / sigma).tolist()
    assert float(err[[0, -1]].max()) < 2e-3  # at the sampled states
    assert 0.0 < float(std) < 0.2


def test_no_page_imports_jax():
    pattern = re.compile(r"^\s*(?:>>>\s+|\.\.\.\s+)?(?:import|from)\s+(?:jax|thermoextrap_tpu)\b", re.M)
    pages = sorted(DOCS.glob("*.md"))
    assert len(pages) == 9
    bad = {p.name: pattern.findall(p.read_text()) for p in pages}
    assert not any(bad.values()), bad
