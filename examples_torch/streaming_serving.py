"""Streaming serving: accumulate sample chunks online, predict anytime, on the port.

The PyTorch form of ``examples/streaming_serving.py``.  A live simulation
pushes chunks of (u, x) samples into a small moment state as they are
produced; each update reduces the chunk (K1 on the card) and pools it into
the state with the exact shifted-moment merge, so no samples are kept and
the running prediction is available after every chunk.  The final state is
the one-shot reduction over everything seen, up to float associativity.
Then: checkpoints of the state (``.npz`` and the async saver), a streamed
lnPi grid (K4 a chunk), streamed Poisson-bootstrap replicates (K3 a chunk),
file-fed ingest from text tables and ``.npy`` files through the prefetching
loader, the bucketed runner, and a streaming bundle of ``serving_export``
(whose calls launch no kernel: their launches are printed on a line of their
own).

Run: python examples_torch/streaming_serving.py          (CUDA card, 8 chunks of 2^22)
     python examples_torch/streaming_serving.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import json
import tempfile
import time

import numpy as np
import torch

from thermoextrap_tpu_torch import default_device, idealgas, io_stream
from thermoextrap_tpu_torch import serving_export as se
from thermoextrap_tpu_torch.ops.moments_cuda import LAUNCHES
from thermoextrap_tpu_torch.pipeline import (
    make_bucketed_extrap_runner,
    make_extrap_pipeline,
    make_lnpi_pipeline,
    make_streaming_extrap_pipeline,
    make_streaming_lnpi_pipeline,
)
from thermoextrap_tpu_torch.utils import checkpoint as ck


def main(smoke: bool = SMOKE) -> dict:
    dev = default_device()
    beta0, order = 2.0, 4
    n_chunks = 8
    chunk = 2_000 if smoke else 1 << 22  # samples per chunk
    betas = torch.tensor([1.6, 1.8, 2.0, 2.2, 2.4], dtype=torch.float32, device=dev)
    exact = np.array([float(idealgas.x_ave(float(b))) for b in betas])

    state, update, predict = make_streaming_extrap_pipeline(order, beta0)

    # "live" ingest: a new chunk arrives, the state absorbs it, and the
    # current prediction is ready immediately
    us, xs = [], []
    t_update = 0.0
    for i in range(n_chunks):
        x, u = idealgas.generate_data((chunk, 100), beta0, rng=i, dtype=torch.float32)
        us.append(u)
        xs.append(x)
        t0 = time.perf_counter()
        state = update(state, u, x)
        float(state.wsum)  # sync
        t_update += time.perf_counter() - t0
        if i in (0, n_chunks - 1):
            pred = predict(state, betas).cpu().numpy()
            print(
                f"after chunk {i + 1}/{n_chunks} ({float(state.wsum):.2e} samples): "
                f"max |pred - analytic| = {np.max(np.abs(pred - exact)):.2e}"
            )

    n_total = n_chunks * chunk
    print(
        f"streamed {n_total:.2e} samples in {n_chunks} chunks; "
        f"mean update cost {t_update / n_chunks * 1e3:.1f} ms/chunk (first includes the kernels' load)"
    )

    # the streamed state is exactly the one-shot answer over everything
    run_ = make_extrap_pipeline(order, beta0)
    want = run_(torch.cat(us), torch.cat(xs), betas).cpu().numpy()
    got = predict(state, betas).cpu().numpy()
    rel = float(np.max(np.abs(want - got) / np.abs(want)))
    print(f"streamed vs one-shot relative error: {rel:.2e}")
    if not rel < 1e-4:  # float32 chunks: summation-order roundoff
        raise SystemExit(f"streamed state off the one-shot answer by {rel:.2e}")

    # prediction accuracy vs the analytic ideal gas at beta0
    beta0_err = float(abs(got[2] - exact[2]))
    if not beta0_err < 5e-3:
        raise SystemExit(f"streamed prediction at beta0 off the analytic <x> by {beta0_err:.2e}")

    # ---- restartable ingest: checkpoint the accumulator to one npz file;
    # a preempted producer resumes from it and replays only later chunks
    with tempfile.TemporaryDirectory() as td:
        ckpt = Path(td) / "stream_ckpt.npz"
        state.save(ckpt)
        resumed = type(state).load(ckpt)
    np.testing.assert_array_equal(predict(resumed, betas).cpu().numpy(), got)
    print("checkpoint/restore round-trip: exact")

    # ---- async checkpointing while ingest continues: the saver snapshots
    # the state and serializes it on a worker thread
    with tempfile.TemporaryDirectory() as td, ck.AsyncPytreeSaver() as saver:
        saver.save(Path(td) / "async_ckpt", state)
        # ... the producer keeps folding chunks here while the write runs ...
        saver.wait()
        restored = ck.restore_pytree(Path(td) / "async_ckpt", state)
    np.testing.assert_array_equal(predict(restored, betas).cpu().numpy(), got)
    print("async checkpoint round-trip: exact")

    # ---- streaming a macrostate grid (lnPi): each chunk carries the whole
    # grid's new energy samples; the state pools elementwise per macrostate
    n_grid, r_chunk = (12, 2_000) if smoke else (256, 1 << 18)
    order_g, beta0_g = 3, 1.4
    gen = torch.Generator(device=dev).manual_seed(3)
    lnpi0 = torch.linspace(0.0, 4.0, n_grid, device=dev)
    mudotn = 0.5 * torch.arange(n_grid, dtype=torch.float32, device=dev)
    gbetas = torch.tensor([1.2, 1.4, 1.6], device=dev)

    g_state, g_update, g_predict = make_streaming_lnpi_pipeline(order_g, beta0_g, grid_shape=(n_grid,))
    gs = []
    for _ in range(4):
        blk = -10.0 + torch.linspace(-1, 1, n_grid, device=dev)[:, None] + torch.randn(
            (n_grid, r_chunk), generator=gen, device=dev, dtype=torch.float32
        )
        gs.append(blk)
        g_state = g_update(g_state, blk)
    grid_pred = g_predict(g_state, lnpi0, mudotn, gbetas).cpu().numpy()
    one_shot = make_lnpi_pipeline(order_g, beta0_g)(torch.cat(gs, dim=-1), lnpi0, mudotn, gbetas).cpu().numpy()
    gerr = float(np.max(np.abs(grid_pred - one_shot)))
    print(f"streamed lnPi grid ({n_grid} macrostates x 4 x {r_chunk:.0e} samples): max |streamed - one-shot| = {gerr:.2e}")
    if not gerr < 1e-3:  # float32 associativity on lnPi magnitudes
        raise SystemExit(f"streamed lnPi grid off the one-shot grid by {gerr:.2e}")
    del gs

    # ---- streaming uncertainty: nrep Poisson-bootstrap replicate
    # accumulators ride in the state (counts drawn in the kernel on the card,
    # no (nrep, chunk) table); predict returns (pred, std) at any point
    c_state, c_update, c_predict = make_streaming_extrap_pipeline(order, beta0, nrep=64, seed=17)
    for i in range(n_chunks):
        c_state = c_update(c_state, us[i], xs[i])
    c_pred, c_std = (a.cpu().numpy() for a in c_predict(c_state, betas))
    z = np.abs(c_pred - exact) / c_std
    print(f"streamed bootstrap CI (nrep=64): std range [{c_std.min():.2e}, {c_std.max():.2e}], max |z| = {z.max():.1f}")
    np.testing.assert_allclose(c_pred, got, rtol=1e-6)  # mean leg untouched
    if not np.all(c_std > 0):
        raise SystemExit("streamed bootstrap CI has a non-positive entry")
    del us, xs

    # ---- file-fed ingest with the prefetching loader: trajectory chunks are
    # parsed (C++ loader) and staged on a worker thread while the update
    # reduces the previous chunk; then the same rows as .npy files
    n_files, r_file = 4, (1_000 if smoke else 1 << 16)
    with tempfile.TemporaryDirectory() as td:
        txt_paths, npy_paths = [], []
        for i in range(n_files):
            x, u = idealgas.generate_data((r_file, 100), beta0, rng=100 + i, device="cpu")
            table = np.stack([u.numpy(), x.numpy()], axis=1)
            txt_paths.append(Path(td) / f"traj_{i}.txt")
            np.savetxt(txt_paths[-1], table)
            npy_paths.append(Path(td) / f"traj_{i}.npy")
            np.save(npy_paths[-1], table.astype(np.float32))
        f_state, f_update, f_predict = make_streaming_extrap_pipeline(order, beta0)
        f_state = io_stream.ingest_stream(f_update, f_state, io_stream.read_table_chunks(txt_paths, columns=(0, 1), depth=2))
        n_state, n_update, n_predict = make_streaming_extrap_pipeline(order, beta0)
        n_state = io_stream.ingest_stream(n_update, n_state, io_stream.read_npy_chunks(npy_paths, columns=(0, 1), depth=2))
    f_pred = f_predict(f_state, betas).cpu().numpy()
    n_pred = n_predict(n_state, betas).cpu().numpy()
    print(
        f"prefetched file ingest ({n_files} files x {r_file:.0e} rows): "
        f"max |pred - analytic| = {np.max(np.abs(f_pred - exact)):.2e} (text), "
        f"{np.max(np.abs(n_pred - exact)):.2e} (.npy)"
    )
    if not (abs(f_pred[2] - exact[2]) < 5e-2 and abs(n_pred[2] - exact[2]) < 5e-2):
        raise SystemExit("file-fed prediction at beta0 off the analytic <x>")

    # ---- bucketed serving: any request size served at a few fixed shapes
    serve = make_bucketed_extrap_runner(order, beta0, buckets=(1 << 11, 1 << 13))
    for r_req in (1_500, 1_800, 5_000):  # three sizes, two buckets
        x, u = idealgas.generate_data((r_req, 100), beta0, rng=r_req, dtype=torch.float32)
        pred = serve(u, x[:, None], betas)
        if not bool(torch.isfinite(pred).all()):
            raise SystemExit(f"bucketed serving at R={r_req} gave a non-finite prediction")
    print(f"bucketed serving: sizes (1500, 1800, 5000) -> buckets {serve.buckets}")

    # ---- streaming bundle: update + predict + initial state in ONE file; the
    # serving process traces nothing, and the bundle's calls launch no kernel
    art = se.export_streaming_extrap_pipeline(order, beta0)
    before = dict(LAUNCHES)
    with tempfile.TemporaryDirectory() as td:
        art.save(td + "/stream.thexport")
        art2 = se.load_exported(td + "/stream.thexport")
        st = art2.init_state(dev)
        x, u = idealgas.generate_data((4_000, 100), beta0, rng=9, dtype=torch.float32)
        st = art2.update(st, u[:2_500], x[:2_500])
        st = art2.update(st, u[2_500:], x[2_500:])  # different chunk length
        b_pred = art2.predict(st, betas).cpu().numpy()
    artifact_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    print(json.dumps({"artifact_launches": artifact_launches}), flush=True)
    bundle_err = float(abs(b_pred[2] - exact[2]))
    print(f"streaming bundle (2 ragged chunks): max |pred - analytic| = {np.max(np.abs(b_pred - exact)):.2e}")
    if not bundle_err < 5e-2:
        raise SystemExit(f"bundle prediction at beta0 off the analytic <x> by {bundle_err:.2e}")
    return {"beta0_abs_err": beta0_err, "stream_vs_one_shot_rel": rel, "grid_stream_abs": gerr, "bundle_beta0_abs_err": bundle_err}


if __name__ == "__main__":
    run(main, "streaming_serving")
