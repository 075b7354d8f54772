#!/usr/bin/env python3
"""Drive the torch port's β-extrapolation main path once on an NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (the kernels in
``thermoextrap_tpu_torch/csrc`` are compiled on first use) and exits non-zero
on any failure, without printing a result.  Phases, one line each:

1. environment and the kernel build;
2. K1 (f32 and bf16) at R = 1e8 and K6 at (100, 1e5) against their plain
   versions on the card;
3. K2 at the main path's shape (R = 1e5, nrep = 100) and at R = 1e7,
   nrep = 100, with int32 and int8 count tables;
4. K3: its counts against their plain reproduction, K3 against K2 on that
   table, and K3 at R = 1e8, nrep = 256 against its plain version;
5. the main path: ideal-gas samples made on the card, the serving pipeline
   (order 6, 256 bootstrap replicates) against the analytic answer and the
   float64 plain reduction, the README quick start, and the count-table
   bootstrap of ``DataCentralMomentsVals``;
6. the kernel launch counts of phase 5;
7. CUDA-event times of each kernel and its plain version at the main path's
   shapes (plus K1 on bfloat16 streams and K2 at R = 1e7), and of the
   pipeline call.

The line before the last is a JSON object with one entry per kernel; the
last line is the device JSON object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ORDER = 6
BETA0 = 5.6
BETAS = (5.2, 5.4, 5.6, 5.8, 6.0)
R_MAIN = 100_000_000
NPART = 8
NREP_MAIN = 256
SEED = 20240607


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from thermoextrap_tpu_torch import DataCentralMomentsVals, beta, factory_data_values, idealgas
    from thermoextrap_tpu_torch.ops import _build, dispatch, resample
    from thermoextrap_tpu_torch.ops import moments_cuda as mc
    from thermoextrap_tpu_torch.pipeline import make_extrap_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def say(phase, **kw):
        print(json.dumps({"phase": phase, **kw}), flush=True)

    def compare(name, got, ref, rtol, atol):
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            a = a.double()
            b = b.double()
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}[{i}]: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
            diff = (a - b).abs()
            worst = max(worst, float(diff.max()))
            bad = diff > atol + rtol * b.abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"{name}[{i}]: {int(bad.sum())} entries beyond rtol {rtol} atol {atol}; max abs err {float(diff.max())}"
                )
        return worst

    def lead(out):
        """The flat view of a (nbatch=1) plain reduction."""
        return out[0][0], out[1][0], out[2][:, 0], out[3][:, 0]

    # -- phase 1: environment and build ---------------------------------------
    say(
        1,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
        card=card,
    )
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    say(
        1,
        build="compiled" if _build.BUILD_INFO["compiled"] else "loaded",
        build_s=time.perf_counter() - t0,
        nvcc_s=_build.BUILD_INFO["seconds"],
    )

    # the main path's samples: 1e8 ideal-gas configurations of 8 particles
    x, u = idealgas.generate_data((R_MAIN, NPART), BETA0, rng=gen, dtype=torch.float32)
    x1 = x[:, None]
    errs = {}

    # -- phase 2: K1 and K6 -----------------------------------------------------
    ref = lead(mc.reduce_comoments_plain(u.double()[None], x1.double()[None], None, ORDER))
    got = mc.reduce_central_comoments_fused(u, x1, ORDER)
    errs["K1"] = compare("K1 f32", got, ref, 2e-3, 1e-5)
    ub, xb = u.to(torch.bfloat16), x1.to(torch.bfloat16)
    ref16 = lead(mc.reduce_comoments_plain(ub.double()[None], xb.double()[None], None, ORDER))
    got16 = mc.reduce_central_comoments_fused(ub, xb, ORDER)
    err16 = compare("K1 bf16", got16, ref16, 2e-3, 2e-5)
    del ub, xb, ref16, got16
    u6 = u[:10_000_000].reshape(100, 100_000)
    x6 = x1[:10_000_000].reshape(100, 100_000, 1)
    ref6 = mc.reduce_comoments_plain(u6.double(), x6.double(), None, ORDER)[:4]
    errs["K6"] = compare("K6", mc.reduce_central_comoments_batched(u6, x6, ORDER), ref6, 2e-3, 1e-5)
    say(2, card=card, K1_f32_max_abs_err=errs["K1"], K1_bf16_max_abs_err=err16, K6_max_abs_err=errs["K6"], rtol=2e-3, atol_f32=1e-5, atol_bf16=2e-5)

    # -- phase 3: K2, at the main path's shape (the count table of a
    # 100-replicate index bootstrap of 1e5 samples), then at R = 1e7 ------------
    r2q, nrep2 = 100_000, 100
    u2q, x2q = u[:r2q], x1[:r2q]
    tableq = resample.freq_from_indices(torch.randint(0, r2q, (nrep2, r2q), generator=gen, device=dev), r2q)
    refq = mc.resample_comoments_plain(u2q.double(), x2q.double(), tableq, ORDER)[:4]
    errq = compare("K2 main-path shape", mc.resample_central_comoments_fused(u2q, x2q, tableq, ORDER), refq, 2e-3, 1e-5)
    r2 = 10_000_000
    u2, x2 = u[:r2], x1[:r2]
    table = torch.poisson(torch.ones((nrep2, r2), device=dev), generator=gen).to(torch.int32)
    ref2 = mc.resample_comoments_plain(u2.double(), x2.double(), table, ORDER)[:4]
    err32 = compare("K2 int32", mc.resample_central_comoments_fused(u2, x2, table, ORDER), ref2, 2e-3, 1e-5)
    err8 = compare("K2 int8", mc.resample_central_comoments_fused(u2, x2, table.to(torch.int8), ORDER), ref2, 2e-3, 1e-5)
    errs["K2"] = max(errq, err32, err8)
    del refq, ref2
    say(
        3,
        card=card,
        K2_main_shape_max_abs_err=errq,
        K2_int32_max_abs_err=err32,
        K2_int8_max_abs_err=err8,
        rtol=2e-3,
        atol=1e-5,
    )

    # -- phase 4: K3 -------------------------------------------------------------
    r3 = 1 << 20
    counts = mc.poisson_counts_cuda(SEED, NREP_MAIN, r3, dev)
    counts_ref = mc._poisson_counts(SEED, NREP_MAIN, r3, dev)
    if not torch.equal(counts, counts_ref):
        raise AssertionError(f"K3 counts differ from their plain reproduction at {int((counts != counts_ref).sum())} entries")
    k3 = mc.resample_central_comoments_poisson(u[:r3], x1[:r3], NREP_MAIN, ORDER, seed=SEED)
    k2 = mc.resample_central_comoments_fused(u[:r3], x1[:r3], counts_ref, ORDER)
    err_k3k2 = compare("K3 vs K2", k3, k2, 1e-6, 1e-9)
    del counts, counts_ref, k3, k2
    k3_main = mc.resample_central_comoments_poisson(u, x1, NREP_MAIN, ORDER, seed=SEED)
    ref3 = mc.resample_poisson_plain(u.double(), x1.double(), NREP_MAIN, ORDER, seed=SEED)[:4]
    errs["K3"] = compare("K3", k3_main, ref3, 2e-3, 1e-5)
    xstd = float(k3_main[0].double().std())
    if not xstd > 0:
        raise AssertionError(f"K3 replicate means do not scatter (std {xstd})")
    del ref3, k3_main
    say(4, card=card, counts_equal=True, K3_vs_K2_max_abs_err=err_k3k2, K3_max_abs_err=errs["K3"], replicate_xave_std=xstd)

    # -- phase 5: the main path, with fresh launch counts --------------------------
    run = make_extrap_pipeline(order=ORDER, beta0=BETA0, nrep=NREP_MAIN)
    betas = torch.tensor(BETAS, dtype=torch.float64)
    mc.reset_launches()
    pred, std = run(u, x, betas, seed=SEED)
    torch.cuda.synchronize()
    qx, qu = idealgas.generate_data((100_000, 1_000), BETA0, rng=gen, dtype=torch.float32)
    data = factory_data_values(uv=qu, xv=qx, order=ORDER, central=True)
    model = beta.factory_extrapmodel(BETA0, data)
    qpred = model.predict([5.2, 6.0])
    boot = model.resample({"nrep": 100, "rng": SEED})
    qstd = boot.predict([5.2, 6.0]).std(dim=1)
    vals = DataCentralMomentsVals.from_vals(qx, qu, ORDER)
    vpred = beta.factory_extrapmodel(BETA0, vals.resample({"nrep": 100, "rng": SEED})).predict([5.2, 6.0])
    torch.cuda.synchronize()
    launches = dict(mc.LAUNCHES)

    truth = torch.stack([idealgas.x_beta_extrap(ORDER, BETA0, b)[0] for b in BETAS]).to(dev)
    if not bool(((pred - truth).abs() <= 5 * std + 1e-6).all()):
        raise AssertionError(f"pipeline prediction outside 5 sigma: pred {pred.tolist()} truth {truth.tolist()} std {std.tolist()}")
    with dispatch.use_impl("torch"):
        pred64 = make_extrap_pipeline(order=ORDER, beta0=BETA0)(u.double(), x.double(), betas)
    plain_diff = float((pred - pred64).abs().max())
    if not bool(((pred - pred64).abs() <= 0.1 * std + 1e-6).all()):
        raise AssertionError(f"pipeline differs from the float64 plain reduction by {plain_diff} (std {std.tolist()})")
    qtruth = torch.stack([idealgas.x_beta_extrap(ORDER, BETA0, b)[0] for b in (5.2, 6.0)]).to(dev)
    if not bool(((qpred.double() - qtruth).abs() <= 5 * qstd.double() + 1e-6).all()):
        raise AssertionError(f"quick start outside 5 sigma: {qpred.tolist()} vs {qtruth.tolist()} (std {qstd.tolist()})")
    if tuple(vpred.shape) != (2, 100) or not bool(torch.isfinite(vpred).all()):
        raise AssertionError(f"DataCentralMomentsVals bootstrap gave {tuple(vpred.shape)} / non-finite values")
    say(
        5,
        card=card,
        betas=list(BETAS),
        pred=pred.tolist(),
        std=std.tolist(),
        analytic=truth.tolist(),
        max_abs_diff_vs_f64_plain=plain_diff,
        quickstart_pred=qpred.tolist(),
        quickstart_std=qstd.tolist(),
        vals_boot_std=vpred.double().std(dim=1).tolist(),
    )

    # -- phase 6: launch counts ----------------------------------------------------------
    missing = [k for k in ("K1", "K2", "K3", "K6") if launches[k] < 1]
    say(6, launches=launches)
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")

    # -- phase 7: times ----------------------------------------------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    ux, xx = u[None], x1[None]
    times = {
        "K1": (
            time_ms(lambda: mc.reduce_central_comoments_fused(u, x1, ORDER), 10),
            time_ms(lambda: mc.reduce_comoments_plain(ux, xx, None, ORDER), 5),
        ),
        "K6": (
            time_ms(lambda: mc.reduce_central_comoments_batched(u6, x6, ORDER), 10),
            time_ms(lambda: mc.reduce_comoments_plain(u6, x6, None, ORDER), 5),
        ),
        "K2": (
            time_ms(lambda: mc.resample_central_comoments_fused(u2q, x2q, tableq, ORDER), 10),
            time_ms(lambda: mc.resample_comoments_plain(u2q, x2q, tableq, ORDER), 5),
        ),
        "K3": (
            time_ms(lambda: mc.resample_central_comoments_poisson(u, x1, NREP_MAIN, ORDER, seed=SEED), 5),
            time_ms(lambda: mc.resample_poisson_plain(u, x1, NREP_MAIN, ORDER, seed=SEED), 2),
        ),
    }
    shapes = {"K1": "R=1e8 V=1 f32", "K6": "(100, 1e5) V=1 f32", "K2": "R=1e5 nrep=100 int32", "K3": "R=1e8 nrep=256"}
    ub, xb = u.to(torch.bfloat16), x1.to(torch.bfloat16)
    extra = {
        "K1": ("R=1e8 V=1 bf16", time_ms(lambda: mc.reduce_central_comoments_fused(ub, xb, ORDER), 10), None),
        "K2": (
            "R=1e7 nrep=100 int32",
            time_ms(lambda: mc.resample_central_comoments_fused(u2, x2, table, ORDER), 5),
            time_ms(lambda: mc.resample_comoments_plain(u2, x2, table, ORDER), 3),
        ),
    }
    t_pipe = time_ms(lambda: run(u, x, betas, seed=SEED), 5)
    for name, (k_ms, p_ms) in times.items():
        say(7, card=card, kernel=name, shape=shapes[name], ms=k_ms, plain_ms=p_ms)
    for name, (shape, k_ms, p_ms) in extra.items():
        say(7, card=card, kernel=name, shape=shape, ms=k_ms, plain_ms=p_ms)
    say(7, card=card, pipeline_ms=t_pipe, R=R_MAIN, nrep=NREP_MAIN, order=ORDER, betas=len(BETAS))

    meta = {
        "K1": ("comoments_reduce.cu", "thermoextrap_tpu/ops/moments_pallas.py:192"),
        "K2": ("comoments_resample.cu", "thermoextrap_tpu/ops/moments_pallas.py:548"),
        "K3": ("comoments_resample.cu", "thermoextrap_tpu/ops/moments_pallas.py:914"),
        "K6": ("comoments_reduce.cu", "thermoextrap_tpu/ops/moments_pallas.py:1875"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"thermoextrap_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, (src, replaces) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
