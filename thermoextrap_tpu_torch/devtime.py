"""Device time and idle share of the port's serving calls on one GPU.

Run from the repository root on a CUDA machine::

    python -m thermoextrap_tpu_torch.devtime [CALL ...]

It builds ``chip_smoke.py``'s inputs (R = 1e8 ideal-gas configurations of 8
particles, the 64 x 1e6 lnΠ grid; same seed) and prints one JSON line per
call: the main path, ⟨u⟩(β), the lnΠ grid and its series engine alone (the
call past its K4 and K5 wrappers), the volume pipeline, K1 alone at
R = 1e8 (one value column at order 6, and the volume path's two at order 1), K3 alone at
the main path's shape (R = 1e8, 256 replicates), at one streaming chunk (R = 1e7) and at the
volume path's two value columns at order 1 (6 rows), K2 at the quick start's
shape (R = 1e5) and at R = 1e7 (100 replicates, int32 and int8 tables), K6 at the quick
start's shape (100 x 1e5), K4 and K5 alone (K4 at the grid in float32 and
bfloat16 and at one row of R = 1e8; K5 at the grid and at one row of
R = 1e8), the perturbation call at R = 1e7 (counts drawn in the kernel, then
from a table) and at R = 1e8, its weight build alone, K7 and K8 alone, one
streaming update of a 1e7-sample chunk, one streaming lnΠ update of a
64 x 250k chunk of the grid, one streaming perturbation update of a
1e7-sample chunk (five targets, 256 replicates: K8 once), and one update (a 1e7 chunk) and one predict
(seven targets, two states of 256 replicates) of the streaming interpolation
over beta 5.2 and 6.0, one call of the bucketed runner on 1e8 - 12345
samples padded to 2^27 (256 replicates), MBAR at ``benches/bench_mbar.py``'s
size (the float32 hybrid solve of K = 4 harmonic states over N = 1e8 pooled
samples, its 256 targets in the alpha kernel, and ``MBARModel.predict`` over the
main samples and two more R = 1e8 sets at beta 5.2 and 6.0), and one
file-fed streaming update (a 1e7-row ``.npy`` file through
``read_npy_chunks`` onto the card and ``ingest_stream``), one
``train_iterative`` at ``chip_smoke.py`` phase 23's size (41 beta in [1, 5],
maxiter 6, each state 1e7 float32 configurations of 100 particles made on
the card, order 4, 100 replicates through K2), K1's forward and backward
through ``ops.dispatch`` at R = 1e8 (order 6, one value column, the
closed-form backward in float64), and the derivative GPR at
``chip_smoke.py`` phase 25 (a)'s configuration (``benches/bench_gpr.py``'s
five ideal-gas states, staged once): one fit (``create_GPR`` on the staged
inputs, float64 on the card) and one ``make_gpr_pipeline`` predict on 200
beta; with names, only those calls.
Each line holds

- ``wall_ms``: mean of 5 warm calls, CUDA events around each call;
- ``device_ms``: device time per call from ``torch.profiler`` over 5 more
  calls, summing device-side activities only (kernels, copies, fills), so
  that an operator and the kernel it launched are not counted twice (a
  kernel's time per call is its mean time over the records the profiler kept,
  times its launches per call, so a lost record does not read as idle time);
- ``idle``: ``1 - device_ms / wall_ms``;
- ``top``: the kernels with the most device time per call, in ms.

``python -m thermoextrap_tpu_torch.devtime --stubs [NAME ...]`` times K5's
tensor-core kernel at the lnΠ grid (64 x 1e6, order 6, 256 replicates) and
at one streaming chunk (64 x 250k, order 7) against stubbed copies of it
(:data:`STUBS`: without its ``mma.sync``, without the draw and the rows of the
next tile, without the draw, without the rows), each built from a copy of
the package under ``_build/stubs/`` and timed in turns, three rounds: one
JSON line per variant and round with the kernel's device ms (three
``device_time`` runs each).  The stubs compute wrong sums; they show what
each part of the kernel costs.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["STUBS", "device_time", "main"]

ORDER = 6
BETA0 = 5.6
BETAS = (5.2, 5.4, 5.6, 5.8, 6.0)
NREP = 256
SEED = 20240607
CALLS = 5
# the profiler's own buffer allocation, reported as a device activity
_OVERHEAD = ("Activity Buffer Request",)
# stubbed variants of K5's tensor-core kernel: edits of csrc/resample_tile.cuh
STUBS = {
    "no_mma": [
        (
            "tx_mma_bf16_16816(tmp[mt], a, bt[k], tmp[mt]);",
            "tmp[mt][0] += __uint_as_float(a[0] ^ bt[k][0] ^ a[3]);",  # keeps the loads
        )
    ],
    "no_production": [
        ("    if (t1 < j_end) {  // the same for every thread of the block", "    if (t1 < j_end && t0 < 0) {")
    ],
    "no_draw": [
        ("hi |= MC::low4(counts, ra, nrep, j, fa);", "fa[0] = fa[1] = fa[2] = fa[3] = (float)(ra & 3);"),
        ("hi |= MC::low4(counts, ra + 8, nrep, j, fb);", "fb[0] = fb[1] = fb[2] = fb[3] = (float)(j & 3);"),
    ],
    "no_rows": [("      filler.build(raw(cur ^ 1), planes(cur ^ 1), t1, j_end);\n", "")],
}


def device_time(fn, calls: int = CALLS):
    """``(wall_ms, device_ms, top)`` per call of ``fn`` (see the module
    docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans: dict[str, list[float]] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and evt.name not in _OVERHEAD:
            spans.setdefault(evt.name[:60], []).append(evt.time_range.elapsed_us() / 1e3)
    # the profiler now and then loses a kernel's record: a kernel seen n times
    # in `calls` calls ran round(n / calls) times a call, at its mean time
    per_kernel = {name: sum(ms) / len(ms) * max(1, round(len(ms) / calls)) for name, ms in spans.items()}
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4])
    return sum(walls) / calls, sum(per_kernel.values()), top


def _k5_times() -> int:
    """One JSON line: K5's tensor-core kernel, device ms at the grid and at
    one streaming chunk (three ``device_time`` runs each)."""
    import torch

    from . import idealgas
    from .ops import moments_cuda as mc

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grid = torch.stack([idealgas.u_sample((1_000_000, n), BETA0, rng=gen, dtype=torch.float32) for n in range(1, 65)])
    chunk = grid[:, :250_000].contiguous()
    out = {}
    for name, fn in (
        ("K5_grid_order6", lambda: mc.resample_central_umoments_batched_poisson(grid, NREP, ORDER, seed=1)),
        ("K5_chunk_64x250k_order7", lambda: mc.resample_central_umoments_batched_poisson(chunk, NREP, ORDER + 1, seed=1)),
    ):
        out[name] = [max(v for k, v in device_time(fn)[2].items() if "resample_mma" in k) for _ in range(3)]
    print(json.dumps(out), flush=True)
    return 0


def _stubs(names) -> int:
    """Build the kernel and its stubbed copies (all at once), then time them
    in turns; see the module docstring."""
    pkg = Path(__file__).resolve().parent
    dirs = {}
    for name in ["kernel", *names]:
        root = pkg / "_build" / "stubs" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(pkg, root / pkg.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        tile = root / pkg.name / "csrc" / "resample_tile.cuh"
        text = tile.read_text()
        for old, new in STUBS.get(name, []):
            if old not in text:
                msg = f"stub {name}: the kernel source no longer holds {old!r}"
                raise RuntimeError(msg)
            text = text.replace(old, new)
        tile.write_text(text)
        dirs[name] = root
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip()
    build = f"from {pkg.name}.ops import _build; _build.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root) for root in dirs.values()]
    if any(proc.wait() != 0 for proc in procs):
        return 1
    for rnd in range(3):
        for name, root in dirs.items():
            out = subprocess.run(
                [sys.executable, "-m", f"{pkg.name}.devtime", "--k5"], cwd=root, capture_output=True, text=True, check=True
            ).stdout
            line = json.loads(out.strip().splitlines()[-1])
            print(json.dumps({"variant": name, "round": rnd, "card": card, **line}), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    from . import idealgas
    from .beta import factory_extrapmodel
    from .data import DataValues
    from .adaptive_interp import train_iterative
    from .data import DataCentralMomentsVals
    from .io_stream import ingest_stream, read_npy_chunks
    from .models import mbar
    from .models.derivatives import central_u_ave_coefs, lnpi_coefs
    from .models.extrap import InterpModel, MBARModel, _poly_eval
    from .ops import dispatch
    from .ops import moments_cuda as mc
    from .ops.resample import poisson1_freq
    from .pipeline import (
        _perturb_weights,
        make_bucketed_extrap_runner,
        make_extrap_pipeline,
        make_lnpi_pipeline,
        make_perturb_pipeline,
        make_streaming_extrap_pipeline,
        make_streaming_interp_pipeline,
        make_streaming_lnpi_pipeline,
        make_streaming_perturb_pipeline,
        make_volume_pipeline,
    )

    if not torch.cuda.is_available():
        print("devtime: no CUDA device")
        return 1
    if sys.argv[1:2] == ["--k5"]:
        return _k5_times()
    if sys.argv[1:2] == ["--stubs"]:
        return _stubs(sys.argv[2:] or list(STUBS))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, u = idealgas.generate_data((100_000_000, 8), BETA0, rng=gen, dtype=torch.float32)
    grid = torch.stack([idealgas.u_sample((1_000_000, n), BETA0, rng=gen, dtype=torch.float32) for n in range(1, 65)])
    ncoord = torch.arange(1, 65, dtype=torch.float64, device=dev)
    betas = torch.tensor(BETAS, dtype=torch.float64)
    volumes = torch.tensor((0.9, 0.95, 1.0, 1.05, 1.1), dtype=torch.float64)
    run = make_extrap_pipeline(order=ORDER, beta0=BETA0, nrep=NREP)
    run_u = make_extrap_pipeline(order=ORDER, beta0=BETA0, x_is_u=True, nrep=NREP)
    run_lnpi = make_lnpi_pipeline(ORDER, BETA0, nrep=NREP)
    run_vol = make_volume_pipeline(1.0, ndim=1, nrep=NREP)
    wv = -BETA0 * u
    # the perturbation path's size: R = 1e7, 128 replicates
    rp, nrep_p = 10_000_000, 128
    up, xp = u[:rp], x[:rp]
    run_pd = make_perturb_pipeline(BETA0, nrep=nrep_p, poisson="device")
    run_pt = make_perturb_pipeline(BETA0, nrep=nrep_p, poisson="table")
    dalpha = (betas.to(dev) - BETA0).float()
    ep = _perturb_weights(up, dalpha, None)
    table = poisson1_freq(gen, (nrep_p, rp), dtype=torch.int8)
    state0, update, _ = make_streaming_extrap_pipeline(ORDER, BETA0, nrep=NREP, seed=SEED)
    pstate0, pupdate, _ = make_streaming_perturb_pipeline(BETA0, betas, nrep=NREP, seed=SEED)
    # K2: a 100-replicate count table of 1e5 samples (the quick start) and of 1e7
    x1 = x[:, None]
    table2 = torch.poisson(torch.ones((100, rp), device=dev), generator=gen).to(torch.int32)
    table2q = table2[:, :100_000].contiguous()
    table28, table2q8 = table2.to(torch.int8), table2q.to(torch.int8)
    x2 = torch.stack([x, x * x], dim=1)  # the volume path's two value columns
    u6, x6 = u[:10_000_000].reshape(100, 100_000), x1[:10_000_000].reshape(100, 100_000, 1)
    lnpi0, mudotn = -0.01 * ncoord**2, 0.3 * ncoord
    # the lnΠ call past its K4 and K5 wrappers (make_lnpi_pipeline's run on
    # their outputs): the series engine, the Taylor sums, the replicates' std
    uave_g, du_g = (t.double() for t in mc.reduce_central_umoments_batched(grid, ORDER))
    bu_g, bdu_g = mc.resample_central_umoments_batched_poisson(grid, NREP, ORDER, seed=SEED)

    def lnpi_series():
        dalpha = torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float64, device=dev)) - BETA0
        pred = _poly_eval(lnpi_coefs(central_u_ave_coefs(uave_g, du_g, ORDER - 1), lnpi0, mudotn, ORDER), dalpha)
        coefs = lnpi_coefs(central_u_ave_coefs(bu_g.double(), bdu_g.double(), ORDER - 1), lnpi0[None], mudotn[None], ORDER)
        return pred, _poly_eval(coefs, dalpha).std(dim=1, correction=0)

    gstate0, gupdate, _ = make_streaming_lnpi_pipeline(ORDER, BETA0, grid_shape=(64,), nrep=NREP, seed=SEED)
    gchunk = grid.chunk(4, dim=1)[1]  # a 64 x 250k chunk, as a view of the grid
    gridb = grid.to(torch.bfloat16)
    # the streaming interpolation over beta 5.2 and 6.0: one update of a 1e7
    # chunk, and one predict at seven targets from states of one 1e7 chunk each
    istates0, iupdate, ipredict = make_streaming_interp_pipeline(ORDER, (5.2, 6.0), nrep=NREP, seed=SEED)
    istates = iupdate(iupdate(istates0, 0, up, xp), 1, u[rp : 2 * rp], x[rp : 2 * rp])
    ibetas = torch.tensor((*BETAS, 5.3, 5.7), dtype=torch.float64)
    # the bucketed runner on R = 1e8 - 12345 samples, padded to 2^27
    serve = make_bucketed_extrap_runner(ORDER, BETA0, nrep=NREP)
    rb = 100_000_000 - 12_345
    # MBAR: K = 4 harmonic states, sigma in [1, 3], N = 1e8 pooled float32
    # samples; 256 targets alpha x^2 / 2 with sigma_a in [1, 3]; the model over
    # three R = 1e8 ideal-gas sets
    sig = torch.linspace(1.0, 3.0, 4, dtype=torch.float64)
    xs = torch.cat([float(s) * torch.randn(25_000_000, generator=gen, device=dev) for s in sig])
    u_kn = xs[None] ** 2 / (2.0 * sig.float().to(dev)[:, None] ** 2)
    n_k = torch.full((4,), 25_000_000.0, device=dev)
    f_k = mbar.mbar_solve(u_kn, n_k)
    alphas = (1.0 / torch.linspace(1.0, 3.0, 256, dtype=torch.float64, device=dev) ** 2).float()
    u_base, x_n = xs**2 / 2.0, torch.stack([xs, xs**2], dim=1)
    sets = {BETA0: (x, u)}
    for k, b in enumerate((5.2, 6.0)):
        sets[b] = idealgas.generate_data((100_000_000, 8), b, rng=torch.Generator(device=dev).manual_seed(SEED + 1 + k), dtype=torch.float32)
    mbar_model = MBARModel(
        [factory_extrapmodel(b, DataValues.from_vals(xb, ub, order=0), order=0) for b, (xb, ub) in sorted(sets.items())]
    )
    # a 1e7-row (u, x) .npy file, read onto the card for one streaming update
    tmp = tempfile.TemporaryDirectory()
    npy_path = f"{tmp.name}/chunk.npy"
    np.save(npy_path, torch.stack([up, xp], dim=1).cpu().numpy())

    def train_state(b):
        """A state of phase 23's trainer: its samples and table seeded from
        SEED and the bits of float32(b)."""
        seed = (SEED + int(np.float32(b).view(np.uint32)) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        xs, us = idealgas.generate_data(
            (10_000_000, 100), b, rng=torch.Generator(device=dev).manual_seed(seed), dtype=torch.float32
        )
        data = DataCentralMomentsVals.from_vals(xs, us, 4).resample({"nrep": 100, "rng": seed ^ 1})
        return factory_extrapmodel(b, data)

    ug, x1g = u.detach().requires_grad_(True), x[:, None].detach().requires_grad_(True)

    def k1_backward():
        out = dispatch.reduce_central(ug, x1g, ORDER)
        return torch.autograd.grad(sum((o * o).sum() for o in out), (ug, x1g))

    from .gpr_active.active_utils import create_GPR, input_GP_from_state
    from .gpr_active.ig_active import extrap_IG
    from .pipeline import make_gpr_pipeline

    gpr_inputs = [
        lambda d=input_GP_from_state(
            extrap_IG(b, rng=torch.Generator(device=dev).manual_seed(SEED + k), nconfig=10_000, npart=1_000, order=4)
        ): d
        for k, b in enumerate((0.5, 1.0, 1.5, 2.0, 2.5))
    ]
    _, gpr_predict = make_gpr_pipeline(gpr_inputs)
    gpr_grid = np.linspace(0.5, 2.5, 200)

    calls = {
        "main_pipeline": lambda: run(u, x, betas, seed=SEED),
        "u_pipeline": lambda: run_u(u, betas, seed=SEED),
        "lnpi_pipeline": lambda: run_lnpi(grid, lnpi0, mudotn, betas, seed=SEED),
        "lnpi_series": lnpi_series,
        "volume_pipeline": lambda: run_vol(wv, x, x, volumes, seed=SEED),
        "K1_1e8": lambda: mc.reduce_central_comoments_fused(u, x1, ORDER),
        "K1_1e8_V2": lambda: mc.reduce_central_comoments_fused(u, x2, 1),
        "K3_1e8": lambda: mc.resample_central_comoments_poisson(u, x1, NREP, ORDER, seed=SEED),
        "K3_1e7": lambda: mc.resample_central_comoments_poisson(up, x1[:rp], NREP, ORDER, seed=SEED),
        "K3_volume_1e8": lambda: mc.resample_central_comoments_poisson(u, x2, NREP, 1, seed=SEED),
        "K2_int32_1e5": lambda: mc.resample_central_comoments_fused(u[:100_000], x1[:100_000], table2q, ORDER),
        "K2_int32_1e7": lambda: mc.resample_central_comoments_fused(up, x1[:rp], table2, ORDER),
        "K2_int8_1e5": lambda: mc.resample_central_comoments_fused(u[:100_000], x1[:100_000], table2q8, ORDER),
        "K2_int8_1e7": lambda: mc.resample_central_comoments_fused(up, x1[:rp], table28, ORDER),
        "K6_100x1e5": lambda: mc.reduce_central_comoments_batched(u6, x6, ORDER),
        "K4_grid_order6": lambda: mc.reduce_central_umoments_batched(grid, ORDER),
        "K4_grid_bf16_order6": lambda: mc.reduce_central_umoments_batched(gridb, ORDER),
        "K4_flat_order7": lambda: mc.reduce_central_umoments_batched(u, ORDER + 1),
        "K5_grid_order6": lambda: mc.resample_central_umoments_batched_poisson(grid, NREP, ORDER, seed=SEED),
        "K5_flat_1e8_order7": lambda: mc.resample_central_umoments_batched_poisson(u[None], NREP, ORDER + 1, seed=SEED),
        "perturb_pipeline_device_1e7": lambda: run_pd(up, xp, betas, seed=SEED),
        "perturb_pipeline_table_1e7": lambda: run_pt(up, xp, betas, seed=SEED),
        "perturb_pipeline_device_1e8": lambda: run_pd(u, x, betas, seed=SEED),
        "perturb_weights_1e7": lambda: _perturb_weights(up, dalpha, None),
        "K7_int8_1e7": lambda: mc.resample_perturb_freq(ep, xp[:, None], table),
        "K8_1e7": lambda: mc.resample_perturb_poisson(ep, xp[:, None], nrep_p, seed=SEED),
        "streaming_update_1e7": lambda: update(state0, up, xp),
        "streaming_lnpi_update_64x250k": lambda: gupdate(gstate0, gchunk),
        "streaming_perturb_update": lambda: pupdate(pstate0, up, xp),
        "interp_update": lambda: iupdate(istates0, 0, up, xp),
        "interp_predict": lambda: ipredict(istates, ibetas),
        "bucketed_serve": lambda: serve(u[:rb], x[:rb], betas, seed=SEED),
        "mbar_solve": lambda: mbar.mbar_solve_info(u_kn, n_k),
        "mbar_alphas": lambda: mbar.mbar_expectations_alphas(u_kn, n_k, f_k, alphas, u_base, x_n, chunk=8),
        "mbar_predict": lambda: mbar_model.predict(betas),
        "ingest_update": lambda: ingest_stream(update, state0, read_npy_chunks([npy_path], columns=(0, 1), device=dev)),
        "trainer_iterative": lambda: train_iterative(np.linspace(1.0, 5.0, 41), train_state, InterpModel, maxiter=6, tol=3e-4),
        "k1_backward": k1_backward,
        "gpr_fit": lambda: create_GPR(gpr_inputs),
        "gpr_predict": lambda: gpr_predict(gpr_grid),
    }
    wanted = sys.argv[1:] or list(calls)
    for name in wanted:
        wall, device, top = device_time(calls[name])
        line = {"call": name, "card": card, "wall_ms": wall, "device_ms": device, "idle": 1.0 - device / wall}
        print(json.dumps({**line, "top": top}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
