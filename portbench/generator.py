"""The one traffic generator: it reads a traffic mix (``traffic/<name>.json``)
and drives a configuration's model through it, one caller in a closed
loop, and then holds what the calls answered against the plain reference.

Modes of a mix:

- ``batch``: back-to-back calls of the model's batch pipeline over all its
  samples, ``nrep`` bootstrap replicates (0: the point estimate alone); call
  ``i`` takes the seed ``derive(seed, CALLS, i)``.
- ``stream``: sessions of ``chunks`` calls; call ``k`` of a session folds
  chunk ``k`` of the samples (``chunks`` equal chunks, in order) into the
  session's state and predicts from it; session ``s`` starts a new state at
  the seed ``derive(seed, SESSIONS, s)``.

A call ends when its answer (the prediction and its standard deviation) is
in host memory.  The checks, once the window has closed: every call's
prediction against the reference's (``pred_err``), and the standard
deviation of ``sigma_checks`` calls spread over the window, the last call
among them (in a stream, of the calls with the most chunks folded in),
against the reference's on the same counts (``sigma_err``).
"""

from __future__ import annotations

import random

from . import compare
from .reference import counts as ref_counts

_M64 = 0xFFFFFFFFFFFFFFFF
CALLS, WARM, SESSIONS, WARM_SESSIONS, PICKS = 1, 2, 3, 4, 5


def _mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed from ``seed`` and ``keys`` (splitmix64)."""
    z = int(seed) & _M64
    for k in keys:
        z = _mix(z ^ _mix(int(k) & _M64))
    return z >> 1


def spread_picks(pool: list, n: int, seed: int) -> list:
    """``n`` of ``pool`` (in the window's order) spread over it: one drawn
    from the seed in each of its first ``n - 1`` equal parts, and its last."""
    if len(pool) <= n:
        return list(pool)
    rng = random.Random(derive(seed, PICKS))
    edges = [len(pool) * k // n for k in range(n)] + [len(pool) - 1]
    return [pool[rng.randrange(edges[k], edges[k + 1])] for k in range(n - 1)] + [pool[-1]]


def _host(out) -> list:
    return [t.cpu().numpy() for t in out]


class BatchLoop:
    def __init__(self, mix: dict, model, cfg: dict, inputs: dict, seed: int, *, control: bool = False):
        self.mix, self.cfg, self.inputs, self.seed = mix, cfg, inputs, seed
        self.nrep = int(mix["nrep"])
        self.call = model.batch(cfg, inputs, self.nrep, control=control)

    def warm(self) -> None:
        for i in range(int(self.mix["warm_calls"])):
            _host(self.call(derive(self.seed, WARM, i)))

    def step(self, i: int) -> dict:
        s = derive(self.seed, CALLS, i)
        out = _host(self.call(s))
        return {"seed": s, "pred": out[0], "std": out[1] if self.nrep else None}

    def close(self) -> None:
        self.call = None

    def check(self, ref, answers: list, device) -> dict:
        betas = self.inputs["betas"]
        point = ref.predict(self.cfg, self.inputs, betas)
        nums = {"pred_err": max(compare.pred_err(a["pred"], point) for a in answers)}
        picks = spread_picks(answers, int(self.mix["sigma_checks"]), self.seed)
        if self.nrep and picks:
            nums["sigma_err"] = max(
                compare.sigma_err(
                    a["std"],
                    ref.predict(
                        self.cfg,
                        self.inputs,
                        betas,
                        counts=ref_counts.for_route(device.type, a["seed"], self.nrep, self.inputs["nrec"], device),
                    ),
                )
                for a in picks
            )
        return nums


class StreamLoop:
    def __init__(self, mix: dict, model, cfg: dict, inputs: dict, seed: int, *, control: bool = False):
        self.mix, self.cfg, self.inputs, self.seed = mix, cfg, inputs, seed
        self.nrep, self.chunks = int(mix["nrep"]), int(mix["chunks"])
        self.session = model.stream(cfg, inputs, self.nrep, self.chunks, control=control)
        self.state = None

    def _fold(self, k: int, session_seed: int) -> list:
        if k == 0:
            self.state, self.update, self.predict = self.session(session_seed)
        self.state = self.update(self.state, k)
        out = self.predict(self.state)
        return _host(out if self.nrep else (out,))

    def warm(self) -> None:
        for s in range(int(self.mix["warm_sessions"])):
            for k in range(self.chunks):
                self._fold(k, derive(self.seed, WARM_SESSIONS, s))

    def step(self, i: int) -> dict:
        s, k = divmod(i, self.chunks)
        seed = derive(self.seed, SESSIONS, s)
        out = self._fold(k, seed)
        return {"seed": seed, "chunks_in": k + 1, "pred": out[0], "std": out[1] if self.nrep else None}

    def close(self) -> None:
        self.session = self.state = self.update = self.predict = None

    def check(self, ref, answers: list, device) -> dict:
        betas = self.inputs["betas"]
        chunk = self.inputs["nrec"] // self.chunks
        points = {k: ref.predict(self.cfg, self.inputs, betas, rows=k * chunk) for k in {a["chunks_in"] for a in answers}}
        nums = {"pred_err": max(compare.pred_err(a["pred"], points[a["chunks_in"]]) for a in answers)}
        longest = max(a["chunks_in"] for a in answers)
        pool = [a for a in answers if a["chunks_in"] == longest]
        picks = spread_picks(pool, int(self.mix["sigma_checks"]), self.seed)
        if self.nrep and picks:
            nums["sigma_err"] = max(
                compare.sigma_err(
                    a["std"],
                    ref.predict(
                        self.cfg,
                        self.inputs,
                        betas,
                        rows=longest * chunk,
                        counts=ref_counts.for_route(
                            device.type, a["seed"], self.nrep, self.inputs["nrec"], device, chunk=chunk
                        ),
                    ),
                )
                for a in picks
            )
        return nums


MODES = {"batch": BatchLoop, "stream": StreamLoop}


def make(mix: dict, model, cfg: dict, inputs: dict, seed: int, *, control: bool = False):
    if mix["loop"] != "closed" or int(mix["callers"]) != 1:
        msg = f"the generator drives one caller in a closed loop, not {mix['callers']} in a {mix['loop']} loop"
        raise ValueError(msg)
    return MODES[mix["mode"]](mix, model, cfg, inputs, seed, control=control)

