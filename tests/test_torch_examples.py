"""Every example CLI of the port runs in ``--smoke`` mode as a subprocess, the
port's counterpart of ``tests/test_examples.py``.

Each script of ``examples_torch/`` (the PyTorch form of the script of the
same name in ``examples/``) runs in its own interpreter: ``--smoke`` steers
it to the CPU at the reference script's smoke sizes
(``examples_torch/_smoke.py``).  A script holds its own bars against the
analytic ideal-gas answer, the golden data or the unsharded functions and
exits non-zero when one fails; its closing JSON line names it, says it ran
in smoke mode and counts no kernel launch.  ``multichip_sharding.py`` runs
its 8 gloo ranks here.  The in-process parity checks against the JAX package
are in ``tests/test_torch_examples_parity.py``.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = sorted(p for p in (Path(__file__).resolve().parent.parent / "examples_torch").glob("*.py") if not p.stem.startswith("_"))


def test_every_reference_example_has_a_port():
    ref = sorted(p.stem for p in (Path(__file__).resolve().parent.parent / "examples").glob("*.py") if not p.stem.startswith("_"))
    assert [p.stem for p in EXAMPLES] == ref


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _numbers(v)
    else:
        yield obj


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_smoke(path):
    proc = subprocess.run([sys.executable, str(path), "--smoke"], capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, (
        f"{path.name} --smoke failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}"
    )
    lines = proc.stdout.strip().splitlines()
    assert len(lines) > 1, f"{path.name} produced no output"
    rec = json.loads(lines[-1])
    assert rec["example"] == path.stem and rec["smoke"] is True
    assert not any(rec["launches"].values()), rec["launches"]  # the CPU runs the plain versions
    assert rec["result"] and all(isinstance(v, (int, float)) and math.isfinite(v) for v in _numbers(rec["result"]))
