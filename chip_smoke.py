"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card, its power limit as ``nvidia-smi`` reports it, and
   the TF32 switches (both forced off: every f32 path is IEEE f32);
2. build: compiles ``src/repro_torch/kernels/csrc/cheb_bsr.cu`` with
   ``nvcc`` for sm_90a (first use), reports how long it took and each
   kernel's registers and spills from ``ptxas -v``, and fails if a union
   kernel or a step strip kernel spills;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on random Block-ELL operands at B = 8 and 16 (random tiles for the
   step, random-graph Laplacian tiles for the union), the step also at
   B = 4 (its generic kernel), and on the deployment operands, in f32 and
   bf16; the step also at F = 100 in slabs of 32 (a ragged last slab), the
   union at F = 100 (a ragged last pass) on the deployment graph tiled at
   B = 8 and at B = 16;
4. main path: with the launch counts set to 0, the paper-shape quickstart
   (``repro_torch.quickstart.main``: N = 500, Tikhonov M = 20, dense and
   bsr fused and stepwise, heat smoothing, SSL) and the deployment shape
   (N = 8192 sensors of the same random geometric model, sigma and kappa
   scaled by sqrt(500/N) to keep the paper's mean degree, F = 256 signals,
   the SGWT bank with eta = 5, M = 20) through ``GraphFilter.apply`` on
   bsr fused, bsr stepwise and dense; then the counts are read and checked;
5. timing at the deployment shape: median CUDA-event milliseconds over 15
   runs after 3 warm-up runs, for the applies and for each kernel beside
   its plain version, with each kernel's bound from the bytes and
   operations of this run's inputs; each kernel's device time from
   ``torch.profiler`` (the event time also holds the wrapper's host
   work); the union kernel's cost per order and per launch from one
   64-column pass at M = 2 and M = 20; one bf16 step (the signal dtype
   only the stepwise route serves); and, as the step kernel's yardstick,
   one ``torch.addmm(t2, S, t1)`` with ``S = L - alpha I`` stored as a
   sparse BSR tensor (CSR where the card refuses BSR), a library call the
   port never makes.

It exits non-zero without printing a result when CUDA is unavailable or
any check fails. The last line is the device record
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PAPER_N, DEPLOY_N, DEPLOY_F, ORDER, BLOCK = 500, 8192, 256, 20, 8
F32_STEP_TOL, BF16_STEP_TOL = 1e-5, 5e-2  # tests/test_kernels.py
UNION_TOL = 2e-4  # tests/test_kernels.py
BF16_REL_BOUND = 16 * 2.0**-8  # tests/test_krylov_precision.py
AGREE_TOL = 2e-4  # deployment: fused, stepwise and dense outputs
BSR_DENSE_TOL = 1e-4  # paper shape: bsr against dense


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout (src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import graph as tgraph
    from repro_torch.core import multipliers as tmult
    from repro_torch.filters import GraphFilter
    from repro_torch.kernels import cheb_bsr, ref as tref
    from repro_torch.kernels._build import build_report, load_library, parse_ptxas_report
    from repro_torch.kernels.autotune import select_tiling, union_grid_barriers
    from repro_torch import quickstart

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device -------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} x{torch.cuda.device_count()}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(smi)
    say(f"[device] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    load_library()
    say(f"[build] nvcc sm_90a build+load {time.perf_counter() - t0:.1f} s")
    ptxas = parse_ptxas_report(build_report())
    builds = {"cheb_union_kernel": 0, "cheb_step_strip_kernel": 0}
    for name, info in sorted(ptxas.items()):
        m = re.search(r"(cheb_(?:union|step|step_strip)_kernel)I(.*?)EEv", name)
        label = f"{m.group(1)}<{m.group(2)}>" if m else name
        say(f"[build] ptxas {label}: {info['registers']} registers, spill stores "
            f"{info['spill_stores']} B, spill loads {info['spill_loads']} B")
        if m and m.group(1) in builds:
            builds[m.group(1)] += 1
            require(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                    f"{label} spills registers")
    require(builds["cheb_union_kernel"] == 4, f"ptxas reported {builds['cheb_union_kernel']} "
            "union kernels (want B 8, 16 x f32, bf16 Krylov)")
    require(builds["cheb_step_strip_kernel"] == 8, f"ptxas reported "
            f"{builds['cheb_step_strip_kernel']} step strip kernels (want B 8, 16 x 4 dtypes)")

    # ---- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def random_bell(n_rows, k_max, block, scale=1.0):
        cols = torch.stack([torch.randperm(n_rows, generator=gen)[:k_max] for _ in range(n_rows)])
        return scale * rand(n_rows, k_max, block, block), cols.to(torch.int32).to(dev)

    def check_step(blocks, cols, t1, t2, alpha, where, f_tile=None):
        worst = 0.0
        for dtype, tol in ((torch.float32, F32_STEP_TOL), (torch.bfloat16, BF16_STEP_TOL)):
            b, x1, x2 = blocks.to(dtype), t1.to(dtype), t2.to(dtype)
            for first in (True, False):
                got = cheb_bsr.cheb_step_cuda(b, cols, x1, x2, alpha=alpha, first=first,
                                              f_tile=f_tile)
                want = tref.cheb_step_ref(b, cols, x1, x2, alpha, first=first)
                err = (got.float() - want.float()).abs()
                ok = bool((err <= tol + tol * want.float().abs()).all())
                require(ok, f"cheb_step {where} {dtype} first={first}: max err {err.max():.3e}")
                if dtype == torch.float32:
                    worst = max(worst, float(err.max()))
                say(f"[kernels] cheb_step {where} {str(dtype)[6:]} first={first} "
                    f"max|kernel-plain| {float(err.max()):.3e} (tol {tol:g}) ok")
        return worst

    def check_union(blocks, cols, f, coeffs, lmax, where):
        got = cheb_bsr.cheb_union_cuda(blocks, cols, f, coeffs=coeffs, lmax=lmax)
        want = tref.cheb_union_ref(blocks, cols, f, coeffs, lmax)
        err = (got - want).abs()
        ok = bool((err <= UNION_TOL + UNION_TOL * want.abs()).all())
        require(ok, f"cheb_union {where} f32: max err {err.max():.3e}")
        say(f"[kernels] cheb_union {where} float32 max|kernel-plain| {float(err.max()):.3e} "
            f"(tol {UNION_TOL:g}) ok")
        got16 = cheb_bsr.cheb_union_cuda(blocks, cols, f, coeffs=coeffs, lmax=lmax,
                                         krylov_dtype=torch.bfloat16)
        want16 = tref.cheb_union_ref(blocks, cols, f, coeffs, lmax, krylov_dtype=torch.bfloat16)
        scale = float(want.abs().max())
        rel_plain = float((got16 - want16).abs().max()) / scale
        rel_f32 = float((got16 - want).abs().max()) / scale
        require(rel_plain < BF16_REL_BOUND and rel_f32 < BF16_REL_BOUND,
                f"cheb_union {where} bf16 krylov: rel {rel_plain:.3e} / {rel_f32:.3e}")
        say(f"[kernels] cheb_union {where} bf16-krylov rel err vs plain-bf16 {rel_plain:.3e}, "
            f"vs f32 {rel_f32:.3e} (bound {BF16_REL_BOUND:.4f}) ok")
        return float(err.max())

    def laplacian_bell(n, block, seed):
        """Block-ELL tiles of a random sensor-graph Laplacian: the union
        recurrence is only stable for a spectrum inside [0, lmax], which
        random tiles do not have (rounding differences grow with order)."""
        g = tgraph.random_sensor_graph(torch.Generator().manual_seed(seed), n, 0.06, 0.065,
                                       device=dev)
        perm = torch.as_tensor(tgraph.spatial_partition_order(g.coords.cpu().numpy(),
                                                              n // block), device=dev)
        bell = tref.bsr_from_dense(g.laplacian()[perm][:, perm], block)
        return bell.blocks, bell.cols, float(g.lmax_bound())

    for block, n_rows, k_max, f in ((8, 64, 4, 33), (16, 32, 3, 64)):
        blocks, cols = random_bell(n_rows, k_max, block)
        t1, t2 = rand(n_rows * block, f), rand(n_rows * block, f)
        check_step(blocks, cols, t1, t2, 3.7, f"random B={block} F={f}")
        blocks, cols, lmax_r = laplacian_bell(n_rows * block, block, seed=block)
        coeffs = torch.randn(3, 13, generator=gen).double().numpy() / (1 + torch.arange(13)).numpy()
        check_union(blocks, cols, t1, coeffs, lmax_r, f"random-graph B={block} F={f}")
    # B = 4: the step's generic kernel (the strip kernel is built for 8 and 16).
    blocks, cols = random_bell(64, 4, 4)
    check_step(blocks, cols, rand(256, 33), rand(256, 33), 3.7, "random B=4 F=33 (generic)")

    # Deployment operands, built on the card.
    n_scale = math.sqrt(PAPER_N / DEPLOY_N)
    t0 = time.perf_counter()
    g = tgraph.random_sensor_graph(
        torch.Generator().manual_seed(7), DEPLOY_N, 0.074 * n_scale, 0.075 * n_scale, device=dev
    )
    lmax = float(g.lmax_bound())
    bank = tmult.sgwt_filter_bank(lmax, 4)
    filt = GraphFilter.from_multipliers(bank, ORDER, graph=g)
    bell = filt.prepare_backend("bsr").bell
    filt.prepare_backend("dense")
    torch.cuda.synchronize()
    n_pad, nnz = bell.n, bell.nnz_blocks
    say(f"[deploy] N={DEPLOY_N} |E|={g.n_edges} mean degree {2 * g.n_edges / DEPLOY_N:.2f} "
        f"lmax={lmax:.3f} block rows {bell.n_block_rows} k_max {bell.k_max} nnz tiles {nnz} "
        f"(padding {1 - nnz / (bell.n_block_rows * bell.k_max):.0%}) "
        f"setup {time.perf_counter() - t0:.1f} s")
    f_deploy = rand(n_pad, DEPLOY_F)
    t2_deploy = rand(n_pad, DEPLOY_F)
    alpha = lmax / 2.0
    step_err = check_step(bell.blocks, bell.cols, f_deploy, t2_deploy, alpha, "deploy")
    union_err = check_union(bell.blocks, bell.cols, f_deploy, filt.coeffs, lmax, "deploy")
    # F = 100: the default tiling takes a pass of 64 columns and a ragged
    # one of 36, at B = 8 and on the same graph tiled at B = 16.
    f_ragged = f_deploy[:, :100].contiguous()
    step_err = max(step_err, check_step(bell.blocks, bell.cols, f_ragged,
                                        t2_deploy[:, :100].contiguous(), alpha,
                                        "deploy F=100 f_tile=32", f_tile=32))
    union_err = max(union_err, check_union(bell.blocks, bell.cols, f_ragged, filt.coeffs, lmax,
                                           "deploy B=8 F=100"))
    bell16 = filt.prepare_backend("bsr", block_size=16).bell
    union_err = max(union_err, check_union(bell16.blocks, bell16.cols, f_ragged, filt.coeffs,
                                           lmax, "deploy B=16 F=100"))

    # ---- 4. the main path, counted ------------------------------------------
    cheb_bsr.reset_launch_counts()
    res = quickstart.main(device=dev)
    require(0.22 <= res["noisy_mse"] <= 0.28, f"paper noisy MSE {res['noisy_mse']:.4f}")
    require(res["denoised_mse"] < 0.02, f"paper denoised MSE {res['denoised_mse']:.4f}")
    require(res["bsr_fused_err"] < BSR_DENSE_TOL and res["bsr_stepwise_err"] < BSR_DENSE_TOL,
            "paper bsr vs dense")
    paper_union, paper_step = cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches
    # quickstart: bsr fused apply, smooth_heat and ssl_classify (fused), one stepwise apply.
    require(paper_union == 3 and paper_step == ORDER,
            f"paper launches union {paper_union} (want 3), step {paper_step} (want {ORDER})")
    say(f"[paper] noisy MSE {res['noisy_mse']:.4f} denoised MSE {res['denoised_mse']:.4f} "
        f"bsr-dense fused {res['bsr_fused_err']:.2e} stepwise {res['bsr_stepwise_err']:.2e} "
        f"heat MSE {res['heat_mse']:.4f} SSL acc {res['ssl_accuracy']:.3f}; "
        f"launches union {paper_union} (1 per fused apply) step {paper_step} ({ORDER} per "
        f"stepwise apply)")

    signal = rand(DEPLOY_N, DEPLOY_F)
    tiling = select_tiling(n_pad, DEPLOY_F, filt.eta, bell.n_block_rows, bell.k_max, BLOCK,
                           sm_count=torch.cuda.get_device_properties(dev).multi_processor_count)
    require(tiling.fuse, "deployment shape should take the fused kernel")
    u0, s0 = cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches
    out_fused = filt.apply(signal, backend="bsr")
    u1, s1 = cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches
    out_step = filt.apply(signal, backend="bsr", fuse=False)
    u2, s2 = cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches
    out_dense = filt.apply(signal, backend="dense")
    torch.cuda.synchronize()
    main_union, main_step = cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches
    require((u1 - u0, s1 - s0) == (1, 0), f"fused apply launched {(u1 - u0, s1 - s0)}")
    require((u2 - u1, s2 - s1) == (0, ORDER), f"stepwise apply launched {(u2 - u1, s2 - s1)}")
    require(main_union > 0 and main_step > 0, "a kernel of the path was never launched")
    require(out_fused.shape == (filt.eta, DEPLOY_N, DEPLOY_F), f"shape {out_fused.shape}")
    require(bool(torch.isfinite(out_fused).all()), "non-finite fused output")
    d_fs = float((out_fused - out_step).abs().max())
    d_fd = float((out_fused - out_dense).abs().max())
    d_sd = float((out_step - out_dense).abs().max())
    require(max(d_fs, d_fd, d_sd) < AGREE_TOL, f"deploy agreement {d_fs:.2e} {d_fd:.2e} {d_sd:.2e}")
    passes = -(-DEPLOY_F // tiling.f_tile)
    barriers = union_grid_barriers(DEPLOY_F, tiling.f_tile, filt.eta, ORDER, BLOCK)
    say(f"[deploy] eta={filt.eta} M={ORDER} F={DEPLOY_F} f_tile={tiling.f_tile} passes {passes} "
        f"grid barriers per fused apply {barriers}: "
        f"max|fused-stepwise| {d_fs:.2e} |fused-dense| {d_fd:.2e} |stepwise-dense| {d_sd:.2e} "
        f"(tol {AGREE_TOL:g}); launches union 1 per fused apply, step {ORDER} per stepwise apply")
    say(f"[main path] launches in the counted run: cheb_union {main_union}, "
        f"cheb_step {main_step}")

    # ---- 5. timing ------------------------------------------------------------
    def median_ms(fn, reps=15, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    fp = f_deploy
    apply_ms = {
        "bsr_fused": median_ms(lambda: filt.apply(signal, backend="bsr")),
        "bsr_stepwise": median_ms(lambda: filt.apply(signal, backend="bsr", fuse=False)),
        "dense": median_ms(lambda: filt.apply(signal, backend="dense")),
        "plain_union": median_ms(lambda: tref.cheb_union_ref(
            bell.blocks, bell.cols, fp, filt.coeffs, lmax)),
        "plain_stepwise": median_ms(lambda: tref.cheb_apply_bsr_ref(bell, fp, filt.coeffs, lmax)),
    }
    union_ms = median_ms(lambda: cheb_bsr.cheb_union_cuda(
        bell.blocks, bell.cols, fp, coeffs=filt.coeffs, lmax=lmax, f_tile=tiling.f_tile))
    union_plain_ms = apply_ms["plain_union"]
    step_ms = median_ms(lambda: cheb_bsr.cheb_step_cuda(
        bell.blocks, bell.cols, fp, t2_deploy, alpha=alpha))
    step_plain_ms = median_ms(lambda: tref.cheb_step_ref(
        bell.blocks, bell.cols, fp, t2_deploy, alpha))
    fp16, t2_16 = fp.bfloat16(), t2_deploy.bfloat16()
    step_bf16_ms = median_ms(lambda: cheb_bsr.cheb_step_cuda(
        bell.blocks, bell.cols, fp16, t2_16, alpha=alpha))

    # The step kernel's yardstick: both step variants have cb / ca = -alpha,
    # so a step is addmm(t2, S, t1, beta=cc, alpha=ca) with S = L - alpha I.
    ca, _, cc = tref.step_constants(alpha, False)
    s_dense = tref.bsr_to_dense(bell) - alpha * torch.eye(n_pad, device=dev)
    try:
        s_lib, lib_format = s_dense.to_sparse_bsr((BLOCK, BLOCK)), "bsr"
        torch.addmm(t2_deploy, s_lib, fp, beta=cc, alpha=ca)
    except (RuntimeError, NotImplementedError) as exc:
        say(f"[timing] addmm on sparse BSR refused ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0]}); timing CSR instead")
        s_lib, lib_format = s_dense.to_sparse_csr(), "csr"
    del s_dense
    lib_out = torch.addmm(t2_deploy, s_lib, fp, beta=cc, alpha=ca)
    want = tref.cheb_step_ref(bell.blocks, bell.cols, fp, t2_deploy, alpha)
    lib_err = (lib_out - want).abs()
    require(bool((lib_err <= F32_STEP_TOL + F32_STEP_TOL * want.abs()).all()),
            f"addmm yardstick disagrees with the plain step: {float(lib_err.max()):.3e}")
    step_lib_ms = median_ms(lambda: torch.addmm(t2_deploy, s_lib, fp, beta=cc, alpha=ca))
    say("[timing] deployment applies, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in apply_ms.items()))

    # Device time of each kernel, without the host work the events include.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            cheb_bsr.cheb_union_cuda(bell.blocks, bell.cols, fp, coeffs=filt.coeffs, lmax=lmax)
            cheb_bsr.cheb_step_cuda(bell.blocks, bell.cols, fp, t2_deploy, alpha=alpha)
            cheb_bsr.cheb_step_cuda(bell.blocks, bell.cols, fp16, t2_16, alpha=alpha)
        torch.cuda.synchronize()
    device_ms = {}
    for ev in prof.key_averages():
        for name in ("cheb_union_kernel", "cheb_step_strip_kernel"):
            if name in ev.key and ev.count:
                us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
                label = name + (" bf16" if "bfloat16" in ev.key else "")
                device_ms[label] = us / ev.count / 1e3
    # One 64-column pass at M = 2 and 20: the slope is the cost of an order
    # (its gathers and its grid barrier), the rest the cost of a launch.
    f64 = fp[:, :64].contiguous()
    one_pass = {m: median_ms(lambda m=m: cheb_bsr.cheb_union_cuda(
        bell.blocks, bell.cols, f64, coeffs=filt.coeffs[:, :m + 1], lmax=lmax))
        for m in (2, ORDER)}
    per_order = (one_pass[ORDER] - one_pass[2]) / (ORDER - 2)
    say("[timing] device ms (torch.profiler): " + ", ".join(
        f"{k} {v:.4f}" for k, v in device_ms.items()) + (" (none traced)" if not device_ms else ""))
    say(f"[timing] cheb_union one 64-column pass: M=2 {one_pass[2]:.4f} ms, M={ORDER} "
        f"{one_pass[ORDER]:.4f} ms -> {per_order * 1e3:.2f} us per order, "
        f"{(one_pass[2] - 2 * per_order) * 1e3:.1f} us per launch")

    # Bounds from this run's inputs: each input read once, each output
    # written once; operations count only the nonzero entries of L (the
    # zeros inside stored tiles and the padding tiles need no work).
    nnz_l = int(torch.count_nonzero(bell.blocks))
    tile_bytes = bell.blocks.numel() * 4 + bell.cols.numel() * 4
    sig = n_pad * DEPLOY_F
    eta = filt.eta
    union_bytes = tile_bytes + sig * 4 + filt.coeffs.size * 4 + eta * sig * 4
    union_flops = ORDER * (2 * nnz_l * DEPLOY_F + 4 * sig) + eta * (ORDER + 1) * 2 * sig
    step_bytes = tile_bytes + 3 * sig * 4
    step_flops = 2 * nnz_l * DEPLOY_F + 5 * sig

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    ub, ub_by = bound(union_bytes, union_flops)
    sb, sb_by = bound(step_bytes, step_flops)
    say(f"[timing] cheb_union kernel {union_ms:.3f} ms (plain {union_plain_ms:.3f}, bound "
        f"{ub:.4f} by {ub_by}: {union_bytes / 1e6:.1f} MB, {union_flops / 1e9:.2f} GFLOP); "
        f"cheb_step kernel {step_ms:.3f} ms (plain {step_plain_ms:.3f}, bound {sb:.4f} by "
        f"{sb_by}: {step_bytes / 1e6:.1f} MB, {step_flops / 1e9:.3f} GFLOP; bf16 signal "
        f"{step_bf16_ms:.3f}; library addmm on sparse {lib_format} {step_lib_ms:.3f}, "
        f"max|addmm-plain| {float(lib_err.max()):.3e} (tol {F32_STEP_TOL:g}))")
    say(smi)

    kernels = [
        {
            "name": "cheb_union", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cheb_bsr.cu",
            "replaces": "src/repro/kernels/cheb_bsr.py:256",
            "launches": main_union, "launches_per_apply": u1 - u0, "max_abs_err": union_err,
            "ms": union_ms, "device_ms": device_ms.get("cheb_union_kernel"),
            "plain_ms": union_plain_ms,
            "bound_ms": ub, "bound_by": ub_by, "library_ms": None,
        },
        {
            "name": "cheb_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cheb_bsr.cu",
            "replaces": "src/repro/kernels/cheb_bsr.py:85",
            "launches": main_step, "launches_per_apply": s2 - s1, "max_abs_err": step_err,
            "ms": step_ms, "device_ms": device_ms.get("cheb_step_strip_kernel"),
            "plain_ms": step_plain_ms,
            "bound_ms": sb, "bound_by": sb_by, "library_ms": step_lib_ms,
            "library_call": f"torch.addmm on sparse {lib_format}", "bf16_ms": step_bf16_ms,
            "bf16_device_ms": device_ms.get("cheb_step_strip_kernel bf16"),
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
