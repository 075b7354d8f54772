"""The harness keeps JAX and the JAX package out: the run's own check on
``sys.modules`` compares whole top-level names, no file of the harness
imports them or reads the JAX package's benchmarks, and ``run.py`` prints
no result without a card or without the program beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import REPO

from portbench import harness

HARNESS = REPO / "portbench"


@pytest.mark.parametrize(
    "planted", ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "thermoextrap_tpu", "thermoextrap_tpu.ops.moments"]
)
def test_check_rejects_a_planted_module(planted):
    assert harness.foreign_modules(["torch", "thermoextrap_tpu_torch", planted]) == [planted.split(".")[0]]


@pytest.mark.parametrize("name", ["thermoextrap_tpu_torch", "thermoextrap_tpu_torch.ops.dispatch", "jaxtyping", "portbench"])
def test_check_accepts_the_port(name):
    assert harness.foreign_modules([name, "torch", "numpy"]) == []


def test_no_harness_file_names_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|thermoextrap_tpu|benches)(\s|\.|$)", re.M)
    for path in HARNESS.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        assert not bad.search(text), path
        assert "bench.py" not in text.replace("portbench", "") and "BENCH_" not in text, path


def _run(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    args = [sys.executable, "portbench/run.py", "--workload", "ig_beta6.point", "--seed", "3", "--seconds", "1", "--trace", "0"]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    res = _run(REPO)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_harness_alone_no_result(tmp_path):
    """Beside BENCHMARK.json and the harness alone there is no program to
    load: no cell gets as far as its inputs."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HARNESS, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "traces"))
    assert _run(tmp_path).returncode != 0
    code = "from portbench import harness; harness.model(harness.load_cell('ig_beta6.point').config)"
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "thermoextrap_tpu_torch" in res.stderr
