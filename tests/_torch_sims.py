"""Simulation functions for ``SimWrapper``'s process tests of the torch port.
They live in a module that imports numpy alone, because each spawned child
imports the module of the function it runs."""

import os

import numpy as np


def fake_sim(rep_dir, beta, npart=200, nframes=500):
    """Write reference-format sim_info.txt / cv_bias.txt files of ideal-gas
    samples from a numpy seed keyed on beta and the directory."""
    rng = np.random.default_rng(int(round(float(beta) * 1000)) + len(rep_dir))
    pos = -np.log1p(-rng.random((nframes, npart)) * (1.0 - np.exp(-beta))) / beta
    x, u = pos.mean(-1), pos.sum(-1)
    steps = np.arange(nframes)
    np.savetxt(os.path.join(rep_dir, "sim_info.txt"), np.stack([steps, np.zeros(nframes), u], axis=1))
    np.savetxt(os.path.join(rep_dir, "cv_bias.txt"), np.stack([steps, x, np.zeros(nframes)], axis=1))


def failing_sim(rep_dir, beta):
    msg = "simulated failure"
    raise RuntimeError(msg)
