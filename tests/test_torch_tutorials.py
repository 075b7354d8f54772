"""The port's four tutorial pages (``docs_torch/tutorial_*.md``) run as
doctests on the CPU, the port's counterpart of
``tests/test_doctests.py::test_tutorials_execute``.

``doctest.testfile`` parses the ``>>>`` examples straight from the markdown
and holds every shown output (ELLIPSIS, NORMALIZE_WHITESPACE).  Each page is
one case, gated at the number of examples it holds, so a page cannot lose
examples unnoticed; the JAX gate's floor is 5 a page.  ``chip_smoke.py``
phase 30 runs the same pages on the CUDA card and holds the same counts.
"""

import doctest
from pathlib import Path

import pytest
from _torch_parity import tt  # noqa: F401  (pins the default device to the CPU)

DOCS = Path(__file__).resolve().parent.parent / "docs_torch"

# examples each page runs; chip_smoke.py's TUTORIAL_EXAMPLES holds the same
ATTEMPTED = {
    "tutorial_beta_extrap.md": 32,
    "tutorial_gpr_active.md": 38,
    "tutorial_lnpi.md": 43,
    "tutorial_serving.md": 47,
}
REFERENCE_FLOOR = 5


def test_every_tutorial_page_is_gated():
    assert sorted(p.name for p in DOCS.glob("tutorial_*.md")) == sorted(ATTEMPTED)
    # the card runs each page at the same count (chip_smoke.py phase 30)
    import chip_smoke

    assert {page: n for page, (n, _) in chip_smoke.TUTORIAL_PAGES.items()} == ATTEMPTED


@pytest.mark.parametrize("page", sorted(ATTEMPTED))
def test_tutorial_executes(page, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    r = doctest.testfile(str(DOCS / page), module_relative=False, optionflags=flags, verbose=False)
    assert r.failed == 0, f"{page}: {r.failed} of {r.attempted} examples failed"
    assert r.attempted == ATTEMPTED[page] >= REFERENCE_FLOOR, f"{page}: {r.attempted} examples run"
