"""With the timed path broken underneath, a run's ``correct`` comes out
false: for each fault a cell can have, at the tiny CPU size.

- the answer altered where it is produced (the prediction by a thousandth
  of itself, the bootstrap deviation by 5%);
- half of the samples left out, the moments taken over the rest (half of
  each chunk of a stream): the last axis of each input the model names in
  its ``SAMPLE_KEYS``;
- a streaming step that returns its state unchanged (every chunk of a
  session after its first);
- the bootstrap deviation altered on every call after the window's first
  (a replicate buffer gone stale), which only the deviation checks of later
  calls can see.

One chip and no exchange between chips: that fault has no place here.
"""

import json
import types

import pytest
import torch
from conftest import BENCH, CELLS, REPO, SEED, run_tiny, sizes

from portbench import generator, harness

MODELS = sorted(p.stem for p in (REPO / "portbench" / "models").glob("*.py"))


def _patched(monkeypatch, wrap):
    real = harness.model

    def fake(config):
        mod = real(config)
        ns = types.SimpleNamespace(**{k: getattr(mod, k) for k in dir(mod) if not k.startswith("__")})
        wrap(ns)
        return ns

    monkeypatch.setattr(harness, "model", fake)


def _alter(ns):
    batch = ns.batch

    def faulty(cfg, inputs, nrep, *, control=False):
        call = batch(cfg, inputs, nrep, control=control)

        def altered(seed):
            out = list(call(seed))
            out[0] = out[0] * (1 + 1e-3)
            if len(out) > 1:
                out[1] = out[1] * 1.05
            return tuple(out)

        return altered

    ns.batch = faulty
    if hasattr(ns, "stream"):
        stream = ns.stream

        def faulty_stream(cfg, inputs, nrep, chunks, *, control=False):
            session = stream(cfg, inputs, nrep, chunks, control=control)

            def s(seed):
                state, update, predict = session(seed)

                def pred(st):
                    p, sd = predict(st)
                    return p * (1 + 1e-3), sd * 1.05

                return state, update, pred

            return s

        ns.stream = faulty_stream


def _half(ns):
    def keep(inputs):
        return {k: (v[..., : v.shape[-1] // 2] if k in ns.SAMPLE_KEYS else v) for k, v in inputs.items()}

    batch = ns.batch
    ns.batch = lambda cfg, inputs, nrep, *, control=False: batch(cfg, keep(inputs), nrep, control=control)
    if hasattr(ns, "stream"):
        stream = ns.stream
        ns.stream = lambda cfg, inputs, nrep, chunks, *, control=False: stream(
            cfg, keep(inputs), nrep, chunks, control=control
        )


def _stale(ns):
    stream = ns.stream

    def stale(cfg, inputs, nrep, chunks, *, control=False):
        session = stream(cfg, inputs, nrep, chunks, control=control)

        def s(seed):
            state, update, predict = session(seed)
            return state, (lambda st, k: st if k else update(st, k)), predict

        return s

    ns.stream = stale


def _late(clean: int):
    """The bootstrap deviation altered by 5% after the first ``clean`` calls."""

    def wrap(ns):
        seen = [0]

        def late(out):
            seen[0] += 1
            return (out[0], out[1] * 1.05) if seen[0] > clean else out

        batch = ns.batch
        ns.batch = lambda cfg, inputs, nrep, *, control=False: (
            lambda call: lambda seed: late(call(seed))
        )(batch(cfg, inputs, nrep, control=control))
        if hasattr(ns, "stream"):
            stream = ns.stream

            def late_stream(cfg, inputs, nrep, chunks, *, control=False):
                session = stream(cfg, inputs, nrep, chunks, control=control)

                def s(seed):
                    state, update, predict = session(seed)
                    return state, update, lambda st: late(predict(st))

                return s

            ns.stream = late_stream

    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(monkeypatch, name):
    _patched(monkeypatch, _alter)
    _, line = run_tiny(name)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_half_the_samples_is_not_correct(monkeypatch, name):
    _patched(monkeypatch, _half)
    _, line = run_tiny(name)
    assert line["correct"] is False
    assert line["checks"]["pred_err"]["value"] > line["checks"]["pred_err"]["limit"]


@pytest.mark.parametrize("name", [c for c in CELLS if harness.load_cell(c).traffic["mode"] == "stream"])
def test_unchanged_stream_state_is_not_correct(monkeypatch, name):
    _patched(monkeypatch, _stale)
    out, line = run_tiny(name, seconds=1.0)
    assert len(out["window"].answers) >= 2
    assert line["correct"] is False
    assert line["checks"]["pred_err"]["value"] > line["checks"]["pred_err"]["limit"]


@pytest.mark.parametrize("name", [c for c in CELLS if harness.load_cell(c).traffic["nrep"]])
def test_late_deviation_fault_is_not_correct(monkeypatch, name):
    mix = harness.load_cell(name).traffic
    warm = int(mix.get("warm_calls", 0)) + int(mix.get("warm_sessions", 0)) * int(mix.get("chunks", 0))
    _patched(monkeypatch, _late(warm + 1))
    out, line = run_tiny(name, seconds=1.0)
    assert len(out["window"].answers) >= 2
    assert line["correct"] is False
    assert line["checks"]["sigma_err"]["value"] > line["checks"]["sigma_err"]["limit"]


@pytest.mark.parametrize("model", MODELS)
def test_model_declares_its_sample_keys(model):
    """The half-samples fault cuts the inputs a model names in
    ``SAMPLE_KEYS``: exactly the tensors of its tiny inputs whose last axis
    holds the ``nrec`` samples, so none is left whole."""
    confs = [json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]]
    conf = next((c for c in confs if c["model"] == model), None)
    assert conf is not None, f"no configuration in BENCHMARK.json runs models/{model}.py"
    cfg = {**conf, **sizes(conf["name"], "tiny")}
    mod = harness.model(cfg)
    keys = mod.SAMPLE_KEYS
    assert isinstance(keys, tuple) and keys and len(set(keys)) == len(keys)
    inputs = mod.make_inputs(cfg, SEED, torch.device("cpu"))
    nrec = inputs["nrec"]
    along = {k for k, v in inputs.items() if isinstance(v, torch.Tensor) and v.dim() and v.shape[-1] == nrec}
    assert set(keys) == along, (keys, sorted(along))


def test_sigma_picks_spread_over_the_window():
    pool = list(range(100))
    for seed in (0, 1, 2**40 + 7):
        picks = generator.spread_picks(pool, 3, seed)
        assert picks[-1] == 99 and len(picks) == 3
        assert 0 <= picks[0] < 33 <= picks[1] < 66
    assert generator.spread_picks(pool[:2], 3, 5) == [0, 1]
    assert generator.spread_picks(pool, 1, 5) == [99]
