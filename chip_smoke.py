"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card, its power limit as ``nvidia-smi`` reports it, and
   the TF32 switches (both forced off: every f32 path is IEEE f32);
2. build: compiles ``src/repro_torch/kernels/csrc/cheb_bsr.cu`` with
   ``nvcc`` for sm_90a (first use), reports how long it took and each
   kernel's registers and spills from ``ptxas -v``, and fails if a union
   kernel, an adjoint kernel or a step strip kernel spills;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on random Block-ELL operands at B = 8 and 16 (random tiles for the
   step, random-graph Laplacian tiles for the union), the step also at
   B = 4 (its generic kernel), and on the deployment operands, in f32 and
   bf16; the step also at F = 100 in slabs of 32 (a ragged last slab), the
   union at F = 100 (a ragged last pass) on the deployment graph tiled at
   B = 8 and at B = 16, and at the solvers' gram shape (eta = 1, order
   2M) on the deployment operands; the adjoint kernel at the lasso's
   (eta, N, F) on the deployment graph, at F = 100 (f_tile 32 at B = 8, a
   ragged last pass; the default tiling at B = 16) and at one squeezed
   column, one launch each;
4. main path: with the launch counts set to 0, the paper-shape quickstart
   (``repro_torch.quickstart.main``: N = 500, Tikhonov M = 20, dense and
   bsr fused and stepwise, heat smoothing, SSL) and the deployment shape
   (N = 8192 sensors of the same random geometric model, sigma and kappa
   scaled by sqrt(500/N) to keep the paper's mean degree, F = 256 signals,
   the SGWT bank with eta = 5, M = 20) through ``GraphFilter.apply`` on
   bsr fused, bsr stepwise and dense; then the counts are read and checked;
5. solvers (``repro_torch.solvers`` and the solver-backed apps), with
   the launch counts set to 0 before each solve and checked exactly after
   it (the adjoint kernel's too: one launch per bsr adjoint, so a lasso
   solve launches iterations + 1 of each). Paper Sec. V-C shape (N =
   500, the SGWT bank with eta = 4, M = 20, mu = 2, on bsr): ISTA
   against FISTA (iterations to ISTA's best objective in 150; FISTA-20 at
   least as good as ISTA-40), bsr against dense, CG inverse filtering,
   Chebyshev-preconditioned CG, the Chebyshev fixed-point inverse, the
   three apps, and one CG solve on the stepwise route (the step kernel on
   the solver path); then each kernel
   against its plain version at those solves' operands (one column; the
   lasso bank, the gram and both fitted inverse series for the union).
   Deployment shape: FISTA on a 256-column panel on bsr against dense,
   and a Wiener solve on bsr against dense; then the peak device memory;
6. timing at the deployment shape: median CUDA-event milliseconds over 15
   runs after 3 warm-up runs, for the applies and for each kernel beside
   its plain version (the adjoint kernel also beside the plain recurrence
   on eta-stacked columns it replaced), with each kernel's bound from the
   bytes and operations of this run's inputs; each kernel's device time
   from ``torch.profiler`` (the event time also holds the wrapper's host
   work); the union kernel's cost per order and per launch from one
   64-column pass at M = 2 and M = 20; one bf16 step (the signal dtype
   only the stepwise route serves); and, as the step kernel's yardstick,
   one ``torch.addmm(t2, S, t1)`` with ``S = L - alpha I`` stored as a
   sparse BSR tensor (CSR where the card refuses BSR), a library call the
   port never makes; and the solver layer: one FISTA iteration on bsr
   and dense split into forward apply, adjoint and the rest, one CG
   iteration on bsr (its order-2M gram, one union launch), the union
   kernel at the gram's shape, and the cost of the tolerance test's host
   synchronisation per iteration;
7. distributed (Algorithm 1 on ``StackedMesh(8)``, all eight ranks on the
   card, outside the counted windows; it must launch no bsr kernel): the
   two distributed example modules at the paper shape; at the deployment
   shape the partition plan (words, padding, host build seconds), halo
   (overlapped and serial), allgather and the halo adjoint against dense,
   FISTA-10 on halo against phase 5's dense FISTA-10, and the grid
   backend on a 128 x 128 grid (depth 2) against dense, all within 2e-4,
   with every exchange count and word count checked exactly; then median
   CUDA-event ms of each, the kernel time per call from
   ``torch.profiler`` and the device's idle share;
8. multi-shift (``GraphFilter.from_shifts``, two commuting shifts of a
   time-vertex product: a sensor graph's Laplacian along the vertex axis,
   a path's along the time axis), every run counted: at the tests' shape
   (24 sensors x 6 samples) dense, bsr fused and stepwise and halo
   (``StackedMesh(8)``) against a host float64 oracle built from the two
   factor eigendecompositions, within 1e-5; at full width (the phase-4
   model at 1024 sensors x a path of 8 samples, N = 8192, F = 256, the
   SGWT bank at M_1 = 20 times heat at M_2 = 5) the same four within
   2e-4, with exact launch counts (union M_1 + 1 per fused apply, 2 M_1 +
   1 per gram; step M_2 (M_1 + 1) per stepwise apply; none on dense, halo
   and the adjoint), exact halo exchanges and words per shift, the bsr
   adjoint identity and gram against composition; each kernel against its
   plain version at one innermost call's operands; a two-shift PCG on bsr
   beside plain CG; then median CUDA-event ms of each joint call, its
   kernel time from ``torch.profiler``, the device's idle share and the
   synchronising operations it makes (none on a joint bsr call: the joint
   coefficients are on the card once per tensor);
9. streaming and churn (``repro_torch.stream``, ``repro_torch.dynamic``),
   every push counted: (a) the ``tab_streaming`` cell at its own shape (80
   x 80 grid, Tikhonov M = 20, 8 parts), its words, modes, changed and
   active counts held to ``BENCH_pr10.json`` exactly and each output to the
   full dense refilter within 1e-5; the same stream on bsr (one union
   launch per full or delta frame, none per cached frame); its 2 % frame
   at F = 1 and F = 256 on dense and bsr beside a full refilter, every
   push against the full dense apply (1e-5 dense, 1e-4 bsr) and the union
   kernel against its plain version at both widths; (b) the deployment
   shape (phase 4's filter, F = 256) with 8 frames of compact 2 % patches
   on dense and bsr (final output against the full dense apply within
   2e-4, launches exact), and a warm-started ``StreamingLasso`` (FISTA,
   tol 5e-5) on bsr at the paper shape (warm iterations <= cold; seeded
   with the previous frame's cold solution, FISTA reaches the cold
   objective within half the cold iterations; launches exact);
   (c) the ``tab_churn`` cell (1600-slot convoy, M = 10, 8 parts) against
   a host-evolved float32 dense oracle within 1e-5 on every frame, with
   the record's mean churn, churn-frame count, words window, fresh-plan
   words and no new churn-kernel key over the second half; then
   at F = 256 (2e-4). Each push series reports per push its CUDA-event ms,
   the host-side ms (reach BFS, topology patch, tracker, plan repair), the
   synchronising operations, and the device's idle share;
10. serving (``repro_torch.serve``, ``GraphFilter.panel_program``) at the
   deployment shape on bsr, every engine and program run counted: one
   apply program per bucket (8 to 128), each recorded as one CUDA graph,
   its replays against eager calls (1e-6), each column against the solo
   bsr apply (1e-5) and the panel against dense (2e-4), one union launch
   per replay, ``memory_allocated`` flat over 5 batches; the union kernel
   replayed from a graph against its plain version at F = 8 and 128; a
   stepwise program (M step launches per replay, the step kernel replayed
   from a graph against its plain version); the FISTA-8 solve programs at
   buckets 8 and 128 (iterations + 1 union and adjoint launches per
   replay, held to the recorded graph's kernel nodes); per bucket the
   eager and replay ms, the host ms to pack, upload and copy back a panel,
   and the synchronising operations per panel. The sync engine
   (``panel_width=128``) on 300 requests per lane against solo applies,
   solo FISTA and standalone streams, launches exact. The async engine on
   a seeded 100000-stream trace (a numpy copy of
   ``benchmarks/loadgen.py::make_trace``), paced at 1000 requests/s over 2
   virtual seconds and in a burst at t = 0, each replayed warm and then
   measured: everything served, no recompile and no capture in the
   measured replay, union launches equal to the lanes' counts; per lane
   p50/p99 virtual latency, capacity beside the sync engine's, pad waste,
   evictions and the device's idle share;
11. gossip and the training substrate (``repro_torch.core.gossip``,
   ``train``, ``optim``, ``runtime``, ``checkpoint``) on
   ``StackedMesh(8)``, outside the counted windows; it must launch no bsr
   kernel (checked). At the example's shape (``repro_torch.gossip_consensus``:
   w 64 x 32, b 32 per rank) exactly: err/init within 1.05 x the minimax
   bound at M = 2-16, ring words equal to the analytic words (399360 at M
   = 12), per-leaf gossip equal to 2- and 4-bucket packing bit for bit in
   f32, bf16 payloads within ``payload_roundoff_bound``, and
   ``StragglerInjector`` counting P (M - r) rounds. Timed: a ~100 M
   parameter f32 tree per rank (six 4096 x 4096 matrices and six
   4096-vectors) at ``required_order(8, 1e-3)`` = 10, packed into 1 and 4
   buckets with f32 and bf16 payloads: median CUDA-event ms per sync and
   per round against the bytes bound, words per rank (exact), peak
   ``memory_allocated`` and err/init against its bound. Then a checkpoint
   round trip of a card tree (f32, bf16, fp8, int32) bit for bit, 5 AdamW
   steps on the card against the CPU (1e-6), and ``run_with_restarts`` of
   a toy trainer through two injected failures (final step, 2 restarts);
12. LM serving (``repro_torch.models``, ``repro_torch.serve.ServeEngine``,
   ``repro_torch.launch.serve``), plain torch with no bsr kernel (checked):
   (a) Gemma-2 2B at its published full width and depth (26 layers, d 2304,
   vocab 256000, bf16, weights from a seeded CUDA generator) through the
   launcher's ``serve`` at batch 4, a 4608-token prompt (past the 4096
   window, so the local layers mask) and 64 new tokens, twice: greedy ids
   equal and in the vocabulary; then the prefill (CUDA events, median of
   3) against its operations bound, the decode step (median of 16) against
   its bytes bound (weights and the whole ``s_max`` cache the naive decode
   reads), every logit finite, tokens/s, peak ``memory_allocated``, the
   synchronising operations per step, and the decode step's idle share
   from ``torch.profiler`` (kernel time over the wall time of 8 steps);
   (b) Gemma-2 2B's full widths at 2 layers (one local, one global) in f32
   with TF32 off, the window cut to 256 for this check only so that a
   1024-token prompt at batch 1 masks while the CPU side stays at about
   0.3 TFLOP: prefill and 8 greedy decode logits on the card against the
   same weights on the CPU within ``LM_NUM_TOL`` (the published window is
   exercised by (a)); (c) all 10 LM archs at smoke width in f32, card
   against CPU: prefill and 4 greedy decode steps, logits within
   ``LM_SMOKE_TOL``, greedy ids equal; (d) at (b)'s shape, chunked
   attention (chunks of 1024, and of 256 to cross chunk boundaries)
   against naive, prefill logits within the reference's 2e-3;
13. training (``repro_torch.train``, ``repro_torch.data``,
   ``repro_torch.launch.train``, ``repro_torch.train_lm``), plain torch with
   no bsr kernel (checked): (a) Gemma-2 2B as published, bf16, random
   weights from a seeded CUDA generator, through ``make_train_step`` and
   ``launch.donation.jit_train_step`` (params and AdamW state updated in
   place) inside ``Trainer`` and ``run_with_restarts`` with a
   ``CheckpointManager``: sequence 4096, 4 sequences in 4 microbatches,
   chunked attention (chunks of 1024), remat "block", f32 moments; 2
   warm-up and 5 timed steps and the Trainer's final checkpoint. Printed:
   step ms (CUDA events, median and range), tokens/s, the share of the
   step's operations bound (model FLOPs, and the executed FLOPs with the
   remat recompute, from the shapes: ``train_work``), one step's device
   time split into GEMMs and the rest with the top kernels and the idle
   share (a fresh ``torch.profiler`` session), peak ``memory_allocated``,
   and the checkpoint's bytes, ``save_async`` and ``wait`` seconds and
   directory. Held: finite losses, ``memory_allocated`` flat within 1 MB
   from step 3 on, the params' storage unchanged across steps. (b) its
   widths at 2 layers in f32 (TF32 off), window 256, batch 1 x 512, chunks
   of 256, remat "block": loss and every gradient leaf card against CPU,
   and the params after one AdamW step (within 2 lr: at step 1 every
   update is +-lr). (c) the ten smoke configs, f32: loss and grads card
   against CPU, and one train step. (d) the ``100m`` preset of
   ``repro_torch.train_lm`` on ``StackedMesh(8)``, f32, batch 16 x 256:
   gossip steps in the serial, bucketed (4 buckets) and delay-slot
   schedules (2 microbatches), the barrier step and the one-device step on
   the same batches; ms per step and the gossip sync's share; held:
   the three schedules within 1e-5, gossip losses within 0.15 |exact| +
   0.05 of the exact step's. (e) ``python -m repro_torch.launch.train
   --arch gemma2_2b --smoke --steps 20`` and ``python -m
   repro_torch.train_lm --preset tiny`` on the card as subprocesses, and a
   restart: a failure injected at step 3 of 6, ``run_with_restarts`` ends
   at step 6 after 1 restart, the resumed losses equal an uninterrupted
   run's within 1e-4;
14. the dry-run tooling (``repro_torch.launch``: ``dryrun``, ``op_costs``,
   ``comm``, ``roofline``), on ``meta`` tensors only (nothing runs on the
   card; no bsr kernel, checked): (a) ``dryrun.main`` on Gemma-2 2B's
   cells (long_500k skipped, as the run matrix says) and ``--gsp`` (halo,
   allgather, ca2), each on the 256- and the 512-card mesh, one line per
   record; held: no error record, and the reference's GSP claims (halo
   collective bytes under 0.25 x allgather's bytes, allgather memory_s
   over 5 x halo's, halo words per matvec = 2 side (P - 1) F exactly);
   (b) the dry run's own ``build_cell`` and ``trace_costs`` at phase
   13's shape and parallel config (4 x 4096 tokens in 4 microbatches,
   chunked attention, remat "block") on a one-card mesh: matmul FLOPs
   within 2 % of ``train_work``'s executed FLOPs, parameter and AdamW
   bytes equal to what the card held, the analysed
   peak (arguments and live bytes) within 25 % of phase 13's measured
   peak above its start; (c) the same for phase 12's prefill (the dry
   run's ``lm.forward(last_only=True)``) and decode step: the
   predicted ms, max(FLOPs / 989 TFLOP/s, eager op-boundary bytes / 3.35
   TB/s), beside the measured device busy ms (reported, not held), and
   the decode step's analysed bytes at least ``lm_work``'s (every weight
   and the whole cache are read).

It exits non-zero without printing a result when CUDA is unavailable or
any check fails. The last line is the device record
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import json
import math
import os
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
ADJOINT_KERNEL_TOL = 1e-5  # tests/test_torch_cuda.py, the adjoint kernel against its plain version
BF16_REL_BOUND = 16 * 2.0**-8  # tests/test_krylov_precision.py
AGREE_TOL = 2e-4  # deployment: fused, stepwise and dense outputs
BSR_DENSE_TOL = 1e-4  # paper shape: bsr against dense
SOLVER_X_TOL, SOLVER_HIST_TOL = 1e-5, 1e-4  # tests/test_solvers.py:128-138
PAPER_SCALES, PAPER_MU, SOLVER_TOL = 3, 2.0, 1e-6
N_PARTS, GRID_SIDE = 8, 128  # the distributed phase: ranks, grid side
# The multi-shift phase: a time-vertex product of MS_SENSORS sensors and a
# path of MS_T samples (N = 8192), orders (M_1, M_2) on the vertex and
# time shifts; the small shape is the tests' (24 sensors x 6 samples).
MS_SENSORS, MS_T, MS_ORDERS, MS_SMALL_TOL = 1024, 8, (ORDER, 5), 1e-5
ADJOINT_RTOL, GRAM_TOL = 2e-5, 5e-4  # tests/test_multishift.py
# The streaming phase. tab_streaming (benchmarks/run.py:534-590): an 80 x 80
# grid, Tikhonov M = 20, 8 parts, and BENCH_pr10.json's (changed, active,
# words) per patch side; its 2 % frame is also timed at F = 1 and at
# STREAM_F columns over STREAM_REPEATS alternating pairs. The deployment stream pushes
# DEPLOY_STREAM_FRAMES 2 % patches. tab_churn (benchmarks/run.py:703-825):
# the convoy scenario, heat/x(1+x) at M = 10, 8 parts, and the record's
# mean churn, words (churn_incremental_frame words_mean 1218, int 1217 over
# 9 frames: a sum in 10958-10961) and fresh-plan words mean.
STREAM_SIDE, STREAM_ORDER, STREAM_PARTS, STREAM_TOL = 80, 20, 8, 1e-5
STREAM_RECORD = {11: (121, 1269, 1030), 18: (324, 2414, 3678), 25: (625, 2333, 2855),
                 40: (1600, 4806, 8181)}
STREAM_FULL_WORDS, STREAM_F, STREAM_REPEATS, DEPLOY_STREAM_FRAMES = 12800, DEPLOY_F, 5, 8
CHURN_SLOTS, CHURN_FRAMES, CHURN_ORDER, CHURN_PARTS = 1600, 10, 10, 8
CHURN_MEAN, CHURN_WORDS_SUM, CHURN_FULL_WORDS_MEAN = 0.0286, (10958, 10961), 2664
LASSO_TOL, LASSO_BUDGET = 5e-5, 12000  # the streaming lasso's tolerance and budget
# The serving phase: the panel buckets, the FISTA budget of the solve lane,
# the sync engine's requests per lane and frame streams, and the seeded
# trace (benchmarks/loadgen.py:67-118: 100000 streams, seed 0, hot 1 % of
# the streams with 50 % of the mass, lanes 0.90/0.08/0.02, 8 tenants, 64
# pooled signals) paced at SERVE_RATE requests/s over SERVE_SECONDS, with
# a SERVE_BUDGET_S latency budget. Replays against eager calls within
# REPLAY_TOL, columns against solo applies within SOLO_TOL
# (tests/test_engine.py), solves against solo FISTA within SERVE_SOLVE_TOL
# (tests/test_solvers.py:265-290).
SERVE_BUCKETS, SERVE_ITERS, SERVE_REQUESTS, SERVE_FRAME_STREAMS = (8, 16, 32, 64, 128), 8, 300, 16
SERVE_STREAMS, SERVE_RATE, SERVE_SECONDS, SERVE_BUDGET_S = 100_000, 1000.0, 2.0, 0.05
REPLAY_TOL, SOLO_TOL, SERVE_SOLVE_TOL = 1e-6, 1e-5, 1e-4
# The gossip phase: P ranks on a StackedMesh. The example's shape (w 64 x 32,
# b 32 per rank; bucketed at M = 12) is checked exactly; the timed tree is
# what a data-parallel user syncs, ~100 M f32 parameters per rank
# (GOSSIP_LEAVES matrices of GOSSIP_SIDE^2 and as many bias vectors), at
# required_order(P, GOSSIP_EPS), packed into each of GOSSIP_BUCKETS buckets.
GOSSIP_RANKS, GOSSIP_ORDER, GOSSIP_LEAVES, GOSSIP_SIDE = 8, 12, 6, 4096
GOSSIP_EPS, GOSSIP_BUCKETS, GOSSIP_REPS = 1e-3, (1, 4), 5
ADAMW_TOL = 1e-6  # card against CPU over 5 steps
# The LM serving phase: Gemma-2 2B at full width through the launcher at
# LM_BATCH x LM_PROMPT prompts and LM_NEW new tokens (s_max = prompt + new
# + 8, as repro/launch/serve.py:53 sets it); the f32 numerics check at 2
# layers, LM_NUM_PROMPT tokens, window LM_NUM_WINDOW, LM_NUM_STEPS decode
# steps; the smoke configs at LM_SMOKE_STEPS decode steps; chunked against
# naive within tests/test_arch_smoke.py:115-116's 2e-3.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "gemma2_2b", 4, 4608, 64
LM_NUM_PROMPT, LM_NUM_WINDOW, LM_NUM_STEPS, LM_NUM_TOL = 1024, 256, 8, 1e-3
LM_SMOKE_STEPS, LM_SMOKE_TOL, LM_CHUNK_TOL = 4, 1e-4, 2e-3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# The training phase: (a) Gemma-2 2B at full width, bf16, sequence
# TRAIN_SEQ (TRAIN_4K's), TRAIN_BATCH sequences in TRAIN_MICRO microbatches,
# chunked attention in chunks of TRAIN_CHUNK, remat "block", TRAIN_WARMUP
# warm-up steps and TRAIN_TIMED timed ones, memory flat within
# TRAIN_MEM_SLACK bytes from step 3 on; (b) its widths at 2 layers in f32,
# window GRAD_WINDOW, GRAD_SEQ tokens: loss within GRAD_LOSS_TOL, each grad
# leaf within GRAD_REL_TOL x max|g| + GRAD_ABS_TOL, params after one AdamW
# step at lr GRAD_LR within 2 lr; (c) the smoke configs within the CPU
# tests' SMOKE_GRAD_TOL (+ SMOKE_GRAD_REL x max|g|; xLSTM also x |g|);
# (d) the 100m preset on StackedMesh(GOSSIP_RANKS), batch GOSSIP_TRAIN_BATCH
# x GOSSIP_TRAIN_SEQ, GOSSIP_TRAIN_STEPS steps per schedule, schedules
# within SCHEDULE_TOL; (e) a restart at RESTART_FAIL_AT of RESTART_STEPS.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_CHUNK = "gemma2_2b", 4096, 4, 4, 1024
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_MEM_SLACK = 2, 5, 1 << 20
GRAD_SEQ, GRAD_WINDOW, GRAD_CHUNK, GRAD_LR = 512, 256, 256, 1e-3
GRAD_LOSS_TOL, GRAD_REL_TOL, GRAD_ABS_TOL = 1e-3, 1e-3, 1e-6
SMOKE_GRAD_TOL, SMOKE_GRAD_REL = 1e-5, 1e-4
GOSSIP_TRAIN_BATCH, GOSSIP_TRAIN_SEQ, GOSSIP_TRAIN_STEPS, SCHEDULE_TOL = 16, 256, 3, 1e-5
RESTART_STEPS, RESTART_FAIL_AT, RESTART_TOL = 6, 3, 1e-4
# The analysis phase: the dry run of ANALYSIS_ARCH's cells and of the GSP cell
# (F = GSP_F signals); phase 13's step analysed within ANALYSIS_FLOP_TOL of its
# executed FLOPs and ANALYSIS_PEAK_TOL of its measured peak.
ANALYSIS_ARCH, GSP_F, ANALYSIS_FLOP_TOL, ANALYSIS_PEAK_TOL = "gemma2_2b", 128, 0.02, 0.25


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps=15, warmup=3):
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` runs after
    ``warmup`` runs."""
    import torch

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


def device_busy_ms(fn, runs=5):
    """Kernel time per call of ``fn``: the summed device time of every
    kernel ``torch.profiler`` traces over ``runs`` calls, divided by
    ``runs``. Against ``median_ms`` of the same call it gives the device's
    idle share (host dispatch the device waits for)."""
    import torch

    fn()
    torch.cuda.synchronize()
    return kernel_ms_once(lambda: [fn() for _ in range(runs)]) / runs


PROFILE_MARGIN_S = 0.25


def kernel_profile_once(fn):
    """One call of ``fn`` under ``torch.profiler``, with no warm-up call
    (for stateful calls such as a stream's push): the summed device time
    (ms) of every kernel traced, and how many traced kernels were the
    union kernel and the step kernels (strip and generic), by name. The
    profiler traces a replayed CUDA graph's kernels one by one.

    The profiler can miss records: on the H100, late in this script, a
    session traced 13 of a replay's 20 step kernels, and without these
    margins a 0.5 s session lost one union kernel of 64. So its counts
    are reported, not held to the launch counters (``graph_kernel_nodes``
    reads a recorded graph's launches from the graph itself), and the
    window is padded with ``PROFILE_MARGIN_S`` of idle time on each side."""
    evs = profiled_kernels(fn)
    union = sum(count for name, _, count in evs if "cheb_union_kernel" in name)
    step = sum(count for name, _, count in evs if "cheb_step" in name)
    return sum(ms for _, ms, _ in evs), (union, step)


def profiled_kernels(fn) -> list[tuple[str, float, int]]:
    """One call of ``fn`` under ``torch.profiler`` inside idle margins
    (``kernel_profile_once``): every kernel traced as (name, summed device
    ms, launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [(ev.key, (getattr(ev, "self_device_time_total", None)
                      or getattr(ev, "self_cuda_time_total", 0)) / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


def kernel_split(evs, per: int = 1, top: int = 4) -> tuple[float, float, str]:
    """Device ms of ``profiled_kernels``' records per call (``per`` calls
    traced): all kernels, the matrix multiplies among them (cuBLAS's
    ``nvjet`` / ``gemm`` kernels), and the ``top`` kernels by time."""
    total = sum(ms for _, ms, _ in evs) / per
    gemm = sum(ms for name, ms, _ in evs
               if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma"))) / per
    heads = sorted(evs, key=lambda e: -e[1])[:top]
    return total, gemm, "; ".join(f"{name[:60]} {ms / per:.3f} ms x{count // per}"
                                  for name, ms, count in heads)


def graph_kernel_nodes(graph) -> tuple[int, int, int]:
    """The union, step (strip and generic) and adjoint kernel nodes of a recorded
    ``torch.cuda.CUDAGraph`` kept with ``keep_graph=True``: what one
    replay launches, read from the graph through the driver's graph API
    (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams_v2``, the kernel's
    name from ``cuFuncGetName`` or ``cuKernelGetName``)."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = fn(*args)
        require(rc == 0, f"{fn.__name__} returned CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes, raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call(cu.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = KernelNodeParams(), ctypes.c_char_p()
        call(cu.cuGraphKernelNodeGetParams_v2, ctypes.c_void_p(node), ctypes.byref(params))
        if params.func:
            call(cu.cuFuncGetName, ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call(cu.cuKernelGetName, ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return (sum("cheb_union_kernel" in nm for nm in names),
            sum("cheb_step" in nm for nm in names),
            sum("cheb_adjoint_union_kernel" in nm for nm in names))


def kernel_ms_once(fn):
    """The summed device time (ms) of every kernel traced in one call of
    ``fn`` (``kernel_profile_once``)."""
    return kernel_profile_once(fn)[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of a call, ms: its bytes over the memory rate or its
    operations over the f32 peak, whichever is larger, and which."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def union_work(nnz_l: int, tile_bytes: int, n: int, f: int, eta: int, order: int):
    """Bytes and operations of one union apply: the tiles, the signal, the
    coefficients and the (eta, N, F) output once each; per order the
    nonzeros of L times F and the recurrence's elementwise terms, and the
    eq. 11 combine."""
    sig = n * f
    nbytes = tile_bytes + sig * 4 + eta * (order + 1) * 4 + eta * sig * 4
    flops = order * (2 * nnz_l * f + 4 * sig) + eta * (order + 1) * 2 * sig
    return nbytes, flops


class LaunchCounter:
    """Runs a call with the kernels' launch counts set to 0 before it,
    reads them after it, and keeps the totals over every counted call.
    It returns the call's result and its ``launch_counts()``: union,
    step, adjoint."""

    def __init__(self, cheb_bsr):
        self.cheb_bsr = cheb_bsr
        self.union = self.step = self.adjoint = 0

    def __call__(self, fn):
        self.cheb_bsr.reset_launch_counts()
        out = fn()
        launched = self.cheb_bsr.launch_counts()
        self.union += launched[0]
        self.step += launched[1]
        self.adjoint += launched[2]
        return out, launched


def expect_launches(what: str, got: tuple, want: tuple) -> None:
    """``got``'s leading counts (union, step[, adjoint]) equal ``want``."""
    names = ("union", "step", "adjoint")[:len(want)]
    got = tuple(got[:len(want)])
    require(got == want, f"{what}: launches ({', '.join(names)}) {got}, want {want}")


def solver_phase(dev, count: LaunchCounter, deploy_filt, deploy_signal,
                 check_union=None, check_step=None) -> dict:
    """Phase 5: the solver layer on the paper's Sec. V-C shape and on the
    deployment shape, every solve counted. ``check_union`` and
    ``check_step`` (phase 3's checks) hold each kernel against its plain
    version at the paper-shape solves' own operands and series."""
    import torch

    from repro_torch import apps
    from repro_torch.core import graph as tgraph
    from repro_torch.core import multipliers as tmult
    from repro_torch.filters import GraphFilter
    from repro_torch import solvers

    def mse(x, ref):
        return float(torch.mean((x - ref) ** 2))

    def maxdiff(a, b):
        return float((a - b).abs().max())

    # Paper Sec. V-C: 500 sensors, f0 = x^2 + y^2 - 1, noise sigma 0.5.
    gen = torch.Generator().manual_seed(42)
    g = tgraph.connected_sensor_graph(gen, n=PAPER_N, device=dev)
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * torch.randn(f0.shape, generator=gen).to(dev)
    lmax = float(g.lmax_bound())
    bank = tmult.sgwt_filter_bank(lmax, PAPER_SCALES)
    filt = GraphFilter.from_multipliers(bank, ORDER, graph=g, lmax=lmax)
    lasso = solvers.LassoProblem(filt=filt, y=y, mu=PAPER_MU)
    noisy = mse(y, f0)

    runs = {}
    for method in ("ista", "fista"):
        res, launched = count(
            lambda m=method: getattr(solvers, m)(lasso, n_iters=150, backend="bsr"))
        expect_launches(f"{method} 150", launched,
                        (res.iterations + 1, 0, res.iterations + 1))
        runs[method] = res
    target = float(runs["ista"].history.min())
    hits = {}
    for method, res in runs.items():
        hit = (res.history <= target).nonzero()[0]
        hits[method] = int(hit[0]) if hit.size else 150
    (ista40, fista20), launched = count(lambda: (solvers.ista(lasso, n_iters=40, backend="bsr"),
                                             solvers.fista(lasso, n_iters=20, backend="bsr")))
    expect_launches("ista 40 + fista 20", launched, (41 + 21, 0, 41 + 21))
    obj_i, obj_f = lasso.objective(ista40.aux), lasso.objective(fista20.aux)
    half_wins = obj_f <= obj_i * (1.0 + 1e-4)
    require(half_wins, f"fista_at_half_wins: FISTA-20 {obj_f:.4f} > ISTA-40 {obj_i:.4f}")
    say(f"[solvers] paper N={PAPER_N} eta={filt.eta} M={ORDER} mu={PAPER_MU} bsr: iterations to "
        f"ISTA-150's best objective {target:.4f}: ista {hits['ista']}, fista {hits['fista']}; "
        f"objective ISTA-40 {obj_i:.4f} FISTA-20 {obj_f:.4f} fista_at_half_wins={int(half_wins)}; "
        f"launches union = adjoint = iterations + 1 per solve")

    ista_b, launched = count(lambda: solvers.ista(lasso, n_iters=10, backend="bsr"))
    expect_launches("ista 10 bsr", launched, (11, 0, 11))
    ista_d, launched = count(lambda: solvers.ista(lasso, n_iters=10, backend="dense"))
    expect_launches("ista 10 dense", launched, (0, 0, 0))
    dx = maxdiff(ista_b.x, ista_d.x)
    dh = float(abs(ista_b.history - ista_d.history).max())
    require(bool(torch.allclose(ista_b.x, ista_d.x, rtol=SOLVER_X_TOL, atol=SOLVER_X_TOL)),
            f"paper ista bsr vs dense x {dx:.2e}")
    require(bool(abs(ista_b.history - ista_d.history).max()
                 <= SOLVER_HIST_TOL * (1 + abs(ista_d.history).max())),
            f"paper ista bsr vs dense history {dh:.2e}")
    say(f"[solvers] paper ISTA-10 bsr vs dense: max|dx| {dx:.2e} (tol {SOLVER_X_TOL:g}), "
        f"max|dhistory| {dh:.2e} (tol {SOLVER_HIST_TOL:g} relative)")

    # CG inverse filtering on the Gram operator, then PCG and cheb_inverse.
    def observe():
        o = filt.apply(f0, backend="bsr")
        return o, filt.adjoint(o, backend="bsr")

    (obs, b), launched = count(observe)
    expect_launches("observe + adjoint", launched, (1, 0, 1))
    gram = solvers.GramProblem(filt=filt, b=b, reg=1e-6)
    cg, launched = count(lambda: solvers.conjugate_gradient(gram, n_iters=150, tol=SOLVER_TOL,
                                                        backend="bsr"))
    expect_launches("cg", launched, (cg.iterations + 1, 0, 0))
    require(cg.converged, f"cg did not converge in 150 ({cg.history[-1]:.2e})")
    cg_err = maxdiff(cg.x, f0)
    pre = solvers.cheb_preconditioner(gram, order=32, backend="bsr")
    pcg, launched = count(lambda: solvers.conjugate_gradient(
        gram, n_iters=150, tol=SOLVER_TOL, backend="bsr", preconditioner=pre))
    expect_launches("pcg", launched, (2 * pcg.iterations + 2, 0))
    pcg_halves = pcg.converged and pcg.iterations <= cg.iterations // 2
    require(pcg_halves, f"pcg_halves: pcg {pcg.iterations} vs cg {cg.iterations}")
    inv, launched = count(lambda: solvers.cheb_inverse(gram, order=16, n_iters=150, tol=SOLVER_TOL,
                                                   backend="bsr"))
    expect_launches("cheb_inverse", launched, (2 * inv.iterations + 1, 0))
    predicted = math.ceil(math.log(SOLVER_TOL) / math.log(inv.aux.rate))
    require(inv.converged and inv.iterations <= predicted + 5,
            f"cheb_inverse {inv.iterations} iterations, predicted {predicted} (+5)")
    say(f"[solvers] paper CG reg=1e-6 tol={SOLVER_TOL:g}: {cg.iterations} iterations, "
        f"max|x-f0| {cg_err:.2e}; PCG fit order {pre.orders[0]} rate {pre.rate:.4f}: "
        f"{pcg.iterations} iterations pcg_halves={int(pcg_halves)}; cheb_inverse order "
        f"{inv.aux.orders[0]} rate {inv.aux.rate:.4f}: {inv.iterations} iterations (predicted "
        f"{predicted}); launches union cg {cg.iterations + 1}, pcg {2 * pcg.iterations + 2}, "
        f"cheb_inverse {2 * inv.iterations + 1}")

    # The step kernel on the solver path: the same CG on the stepwise route.
    cg_s, launched = count(lambda: solvers.conjugate_gradient(gram, n_iters=150, tol=SOLVER_TOL,
                                                          backend="bsr", fuse=False))
    expect_launches("cg fuse=False", launched, (0, 2 * ORDER * (cg_s.iterations + 1)))
    d_step = maxdiff(cg_s.x, cg.x)
    require(cg_s.iterations == cg.iterations and d_step <= SOLVER_X_TOL,
            f"cg stepwise {cg_s.iterations} iterations, fused {cg.iterations}; |dx| {d_step:.2e}")
    say(f"[solvers] paper CG fuse=False: {cg_s.iterations} iterations, max|x - fused x| "
        f"{d_step:.2e} (tol {SOLVER_X_TOL:g}); launches step {launched[1]} = 2M x (iterations + 1)")

    # The three apps.
    den, launched = count(lambda: apps.wavelet_denoise_ista(
        g, y, lmax, n_scales=PAPER_SCALES, order=ORDER, mu=PAPER_MU, backend="bsr",
        full_output=True))
    expect_launches("wavelet_denoise_ista", launched,
                    (den.iterations + 1, 0, den.iterations + 1))
    wie, launched = count(lambda: apps.denoise_wiener(g, y, lmax, noise_power=0.25, order=ORDER,
                                                  backend="bsr", full_output=True))
    expect_launches("denoise_wiener", launched, (wie.iterations + 2, 0, 0))
    rec, launched = count(lambda: apps.inverse_filter(
        g, obs, lmax, bank=bank, order=ORDER, reg=1e-6, n_iters=150, tol=SOLVER_TOL,
        backend="bsr", full_output=True))
    expect_launches("inverse_filter", launched, (rec.iterations + 1, 0, 1))
    mse_ista, mse_wiener = mse(den.x, f0), mse(wie.x, f0)
    require(mse_ista < noisy and mse_wiener < noisy and wie.converged,
            f"denoisers: noisy {noisy:.4f}, ista {mse_ista:.4f}, wiener {mse_wiener:.4f}")
    d_rec = maxdiff(rec.x, cg.x)
    require(rec.converged and rec.iterations == cg.iterations and d_rec <= SOLVER_X_TOL,
            f"inverse_filter {rec.iterations} iterations vs cg {cg.iterations}, |dx| {d_rec:.2e}")
    say(f"[solvers] paper apps bsr: noisy MSE {noisy:.4f}; wavelet_denoise_ista MSE "
        f"{mse_ista:.4f} ({den.iterations} iterations); denoise_wiener MSE {mse_wiener:.4f} "
        f"({wie.iterations} iterations); inverse_filter {rec.iterations} iterations, "
        f"max|x-f0| {maxdiff(rec.x, f0):.2e}, max|x - CG x| {d_rec:.2e}")

    # Each kernel at the paper-shape solves' shapes: one column, the
    # lasso forward bank, the gram, and the two fitted inverse series.
    union_err = step_err = 0.0
    if check_union is not None:
        pb = filt.prepare_backend("bsr").bell
        cgen = torch.Generator().manual_seed(11)
        col, col2 = (torch.randn(pb.n, 1, generator=cgen).to(dev) for _ in range(2))
        for coeffs, where in ((filt.coeffs, f"lasso forward eta={filt.eta} M={ORDER}"),
                              (filt.gram_coeffs[None], f"gram eta=1 M={2 * ORDER}"),
                              (pre.coeffs[None], f"PCG q(L) M={pre.orders[0]}"),
                              (inv.aux.coeffs[None], f"cheb_inverse q(L) M={inv.aux.orders[0]}")):
            union_err = max(union_err, check_union(pb.blocks, pb.cols, col, coeffs, filt.lmax,
                                                   f"paper {where} F=1"))
        step_err = check_step(pb.blocks, pb.cols, col, col2, filt.lmax / 2.0, "paper F=1")

    # Deployment shape: FISTA on a panel, bsr against dense, and Wiener.
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    deploy = solvers.LassoProblem(filt=deploy_filt, y=deploy_signal, mu=PAPER_MU)
    fb, launched = count(lambda: solvers.fista(deploy, n_iters=10, backend="bsr"))
    expect_launches("deploy fista 10 bsr", launched, (11, 0, 11))
    fd, launched = count(lambda: solvers.fista(deploy, n_iters=10, backend="dense"))
    expect_launches("deploy fista 10 dense", launched, (0, 0, 0))
    dfx, dfa = maxdiff(fb.x, fd.x), maxdiff(fb.aux, fd.aux)
    require(max(dfx, dfa) < AGREE_TOL and bool(torch.isfinite(fb.x).all()),
            f"deploy fista bsr vs dense x {dfx:.2e} a {dfa:.2e}")
    wd, launched = count(lambda: solvers.wiener(deploy_filt, deploy_signal, 0.25, n_iters=50,
                                            tol=SOLVER_TOL, backend="bsr"))
    expect_launches("deploy wiener", launched, (wd.iterations + 2, 0))
    require(wd.converged, f"deploy wiener did not converge in 50 ({wd.history[-1]:.2e})")
    wdd, launched = count(lambda: solvers.wiener(deploy_filt, deploy_signal, 0.25, n_iters=50,
                                             tol=SOLVER_TOL, backend="dense"))
    expect_launches("deploy wiener dense", launched, (0, 0))
    dwx = maxdiff(wd.x, wdd.x)
    require(wdd.converged and dwx < AGREE_TOL,
            f"deploy wiener bsr vs dense: {wd.iterations} vs {wdd.iterations} iterations, "
            f"max|dx| {dwx:.2e}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n, f = deploy_signal.shape
    say(f"[solvers] deploy N={n} F={f} eta={deploy_filt.eta} M={deploy_filt.order}: FISTA-10 "
        f"bsr vs dense max|dx| {dfx:.2e} max|da| {dfa:.2e} (tol {AGREE_TOL:g}), launches union "
        f"11, adjoint 11; wiener noise_power=0.25 tol={SOLVER_TOL:g}: {wd.iterations} iterations, "
        f"converged, launches union {wd.iterations + 2}; dense {wdd.iterations} iterations, "
        f"bsr vs dense max|dx| {dwx:.2e} (tol {AGREE_TOL:g}); peak device memory "
        f"{peak / 2**20:.0f} MiB")
    return {"deploy_problem": deploy, "deploy_fista_dense": fd, "union_err": union_err,
            "step_err": step_err}


def solver_timing(deploy_problem, bell, f_tile: int) -> dict:
    """The solver layer's per-iteration times at the deployment shape."""
    from repro_torch import solvers
    from repro_torch.kernels import cheb_bsr
    from repro_torch.kernels.autotune import union_grid_barriers

    filt, y = deploy_problem.filt, deploy_problem.y
    out = {}
    # One FISTA iteration: the slope of fixed-budget solves of 1 and 6
    # iterations; its forward apply (one union launch on bsr) and adjoint
    # timed alone on the same operands; the rest is the difference.
    for backend in ("bsr", "dense"):
        run = {k: median_ms(lambda k=k: solvers.fista(deploy_problem, n_iters=k, backend=backend),
                            reps=5, warmup=1) for k in (1, 6)}
        out[f"fista_{backend}"] = (run[6] - run[1]) / 5
        a = filt.apply(y, backend=backend)
        out[f"forward_{backend}"] = median_ms(lambda: filt.apply(y, backend=backend))
        out[f"adjoint_{backend}"] = median_ms(lambda: filt.adjoint(a, backend=backend))
        out[f"rest_{backend}"] = (out[f"fista_{backend}"] - out[f"forward_{backend}"]
                                  - out[f"adjoint_{backend}"])
    gram = solvers.GramProblem(filt=filt, b=y, reg=0.25)
    mv = gram.operator("bsr")
    out["gram_bsr"] = median_ms(lambda: mv(y))
    out["gram_union_kernel"] = median_ms(lambda: cheb_bsr.cheb_union_cuda(
        bell.blocks, bell.cols, y.contiguous(), coeffs=filt.gram_coeffs[None], lmax=filt.lmax,
        f_tile=f_tile))
    n_iters = 10
    cg_fixed = median_ms(lambda: solvers.conjugate_gradient(
        gram, n_iters=n_iters, tol=None, backend="bsr"), reps=7, warmup=2)
    cg_one = median_ms(lambda: solvers.conjugate_gradient(
        gram, n_iters=1, tol=None, backend="bsr"), reps=7, warmup=2)
    out["cg_iteration_bsr"] = (cg_fixed - cg_one) / (n_iters - 1)
    out["cg_rest_bsr"] = out["cg_iteration_bsr"] - out["gram_bsr"]
    out["gram_grid_barriers"] = union_grid_barriers(
        y.shape[1], f_tile, 1, 2 * filt.order, bell.block_size)
    # The tolerance test's host sync: 40 CG iterations with a tolerance
    # that never fires against the same 40 at a fixed budget, timed in
    # alternating pairs; each pair gives one per-iteration difference.
    n_sync = 40

    def cg(tol):
        return solvers.conjugate_gradient(gram, n_iters=n_sync, tol=tol, backend="bsr")

    diffs = [(median_ms(lambda: cg(1e-30), reps=1, warmup=int(i == 0))
              - median_ms(lambda: cg(None), reps=1, warmup=int(i == 0))) / n_sync
             for i in range(5)]
    out["tol_sync"] = sorted(diffs)
    return out


def distributed_phase(dev, filt, signal, fista_dense, n_parts: int = N_PARTS) -> dict:
    """Phase 7: Algorithm 1 on a ``StackedMesh`` of ``n_parts`` ranks on
    the card — the paper-shape example modules, then the deployment
    shape's halo (both schedules), allgather and adjoint against dense,
    FISTA-10 on halo against dense, and the grid backend on a 128 x 128
    grid; every exchange count and word count checked exactly."""
    import torch

    from repro_torch import distributed_denoising, distributed_wavelet_ista, solvers
    from repro_torch.core import graph as tgraph
    from repro_torch.core import multipliers as tmult
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.filters import GraphFilter

    def maxdiff(a, b):
        return float((a - b).abs().max())

    def expect_calls(mesh, what, want):
        got = dict(mesh.calls)
        require(got == want, f"{what}: collective calls {got}, want {want}")

    # Paper shape: the two example modules on the card, each self-checking.
    den = distributed_denoising.main(device=dev, n_parts=n_parts)
    wav = distributed_wavelet_ista.main(device=dev, n_parts=n_parts)
    say(f"[distributed] paper N={PAPER_N} P={n_parts}: denoising halo/allgather vs dense "
        f"{den['errs']['halo']:.2e}/{den['errs']['allgather']:.2e} (tol 1e-4), words/apply halo "
        f"{den['words']['halo']} allgather {den['words']['allgather']} radio 2M|E| "
        f"{den['radio_words']}, MSE noisy {den['noisy_mse']:.4f} denoised "
        f"{den['denoised_mse']:.4f}, adjoint vs gram {den['gram_err']:.2e} (tol 1e-3); wavelet "
        f"ISTA-20 on halo vs dense {wav['deviation']:.2e} (tol 1e-3), MSE "
        f"{wav['denoised_mse']:.4f}, sparsity {wav['sparsity']:.2f}, words/iteration "
        f"{wav['words_per_iteration']} (radio {wav['radio_words']}), FISTA-10 "
        f"{wav['objective_fista_half']:.4f} <= 1.001 x ISTA-20 {wav['objective_ista']:.4f}")

    # Deployment shape: the plan, built on the host as the reference does.
    n, f = signal.shape
    m = filt.order
    mesh = StackedMesh(n_parts, dev)
    t0 = time.perf_counter()
    plan = filt.prepare_backend("halo", mesh=mesh).plan
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    padded = n_parts * (n_parts - 1) * plan.max_halo * f
    say(f"[distributed] deploy N={n} F={f} P={n_parts}: halo_words {plan.halo_words} max_halo "
        f"{plan.max_halo} n_boundary {plan.n_boundary} (boundary rows per rank "
        f"{int(plan.boundary_counts.min())}-{int(plan.boundary_counts.max())} of "
        f"{plan.n_local}), plan build {plan_s:.2f} s on the host; elements per halo exchange "
        f"{padded} padded against {plan.halo_words * f} in the words model "
        f"({padded / (plan.halo_words * f):.2f}x)")

    dense = filt.apply(signal, backend="dense")
    errs = {}
    for name, backend, opts, kind in (("halo", "halo", {"overlap": True}, "all_to_all"),
                                      ("halo_serial", "halo", {"overlap": False}, "all_to_all"),
                                      ("allgather", "allgather", {}, "all_gather")):
        mesh.reset_counts()
        out = filt.apply(signal, backend=backend, mesh=mesh, **opts)
        torch.cuda.synchronize()
        expect_calls(mesh, f"deploy {name} apply", {kind: m})
        per_exchange = padded if kind == "all_to_all" else plan.n_local * n_parts * (n_parts - 1) * f
        require(mesh.elements[kind] == m * per_exchange,
                f"deploy {name}: {mesh.elements[kind]} elements, want {m * per_exchange}")
        require(out.shape == dense.shape and bool(torch.isfinite(out).all()), f"{name} output")
        errs[name] = maxdiff(out, dense)
        require(errs[name] < AGREE_TOL, f"deploy {name} vs dense {errs[name]:.2e}")
    mesh.reset_counts()
    adjoint = filt.adjoint(dense, backend="halo", mesh=mesh)
    expect_calls(mesh, "deploy halo adjoint", {"all_to_all": m})
    errs["adjoint"] = maxdiff(adjoint, filt.adjoint(dense, backend="dense"))
    require(errs["adjoint"] < AGREE_TOL, f"deploy halo adjoint vs dense {errs['adjoint']:.2e}")
    problem = solvers.LassoProblem(filt=filt, y=signal, mu=PAPER_MU)
    mesh.reset_counts()
    fh = solvers.fista(problem, n_iters=10, backend="halo", mesh=mesh)
    # one forward apply to start, one apply and one adjoint per iteration,
    # one adjoint for the result: M exchanges each
    expect_calls(mesh, "deploy FISTA-10 on halo", {"all_to_all": m * (2 * 10 + 2)})
    errs["fista_x"] = maxdiff(fh.x, fista_dense.x)
    errs["fista_a"] = maxdiff(fh.aux, fista_dense.aux)
    require(max(errs["fista_x"], errs["fista_a"]) < AGREE_TOL,
            f"deploy FISTA-10 halo vs dense x {errs['fista_x']:.2e} a {errs['fista_a']:.2e}")
    words = {b: filt.messages_per_apply(backend=b, mesh=mesh) for b in ("halo", "allgather")}
    require(words["halo"] == m * plan.halo_words, f"halo words {words['halo']}")
    require(words["allgather"] == m * plan.n_local * n_parts * (n_parts - 1),
            f"allgather words {words['allgather']}")
    require(fh.messages_per_iteration == words["halo"] * (1 + filt.eta),
            f"fista words/iteration {fh.messages_per_iteration}")

    # Grid: a 128 x 128 grid, the SGWT bank on lmax = 8, depth 2.
    side, depth = GRID_SIDE, 2
    gg = tgraph.grid_graph(side, device=dev)
    gfilt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(8.0, 4), m, graph=gg, lmax=8.0)
    gsig = torch.randn(side * side, f, generator=torch.Generator().manual_seed(5)).to(dev)
    gmesh = StackedMesh(n_parts, dev)
    gdense = gfilt.apply(gsig, backend="dense")
    gout = gfilt.apply(gsig, backend="grid", mesh=gmesh, depth=depth)
    # One neighbour round for T_1, then one per block of `depth` orders.
    grid_rounds = 1 + math.ceil((m - 1) / depth)
    expect_calls(gmesh, "grid apply", {"shift": 2 * grid_rounds})
    errs["grid"] = maxdiff(gout, gdense)
    require(errs["grid"] < AGREE_TOL, f"grid apply vs dense {errs['grid']:.2e}")
    gmesh.reset_counts()
    gadj = gfilt.adjoint(gdense, backend="grid", mesh=gmesh, depth=depth)
    expect_calls(gmesh, "grid adjoint", {"shift": 2 * m})
    errs["grid_adjoint"] = maxdiff(gadj, gfilt.adjoint(gdense, backend="dense"))
    require(errs["grid_adjoint"] < AGREE_TOL, f"grid adjoint vs dense {errs['grid_adjoint']:.2e}")
    grid_words = gfilt.messages_per_apply(backend="grid", mesh=gmesh, depth=depth)
    require(grid_words == m * 2 * (n_parts - 1) * side, f"grid words {grid_words}")
    say(f"[distributed] deploy eta={filt.eta} M={m}: max|x - dense| halo overlapped "
        f"{errs['halo']:.2e}, "
        f"halo serial {errs['halo_serial']:.2e}, allgather {errs['allgather']:.2e}, halo adjoint "
        f"{errs['adjoint']:.2e}, FISTA-10 on halo x {errs['fista_x']:.2e} a {errs['fista_a']:.2e}; "
        f"grid N={side * side} depth {depth} apply {errs['grid']:.2e} adjoint "
        f"{errs['grid_adjoint']:.2e} (tol {AGREE_TOL:g}); exchanges per apply: halo {m} "
        f"all_to_all (both schedules), allgather {m} all_gather, halo adjoint {m}, grid "
        f"{grid_rounds} neighbour rounds = {2 * grid_rounds} shifts (1 + ceil((M-1)/d)), grid "
        f"adjoint {2 * m} shifts; words/apply halo {words['halo']} = M x {plan.halo_words}, "
        f"allgather {words['allgather']}, grid {grid_words} = M x 2(P-1) x side")

    calls = {
        "halo_overlapped": lambda: filt.apply(signal, backend="halo", mesh=mesh, overlap=True),
        "halo_serial": lambda: filt.apply(signal, backend="halo", mesh=mesh, overlap=False),
        "allgather": lambda: filt.apply(signal, backend="allgather", mesh=mesh),
        "halo_adjoint": lambda: filt.adjoint(dense, backend="halo", mesh=mesh),
        "grid": lambda: gfilt.apply(gsig, backend="grid", mesh=gmesh, depth=depth),
        "grid_adjoint": lambda: gfilt.adjoint(gdense, backend="grid", mesh=gmesh, depth=depth),
    }
    times = {k: median_ms(fn) for k, fn in calls.items()}
    busy = {k: device_busy_ms(fn) for k, fn in calls.items()}
    fista_run = {k: median_ms(lambda k=k: solvers.fista(problem, n_iters=k, backend="halo",
                                                        mesh=mesh)) for k in (1, 6)}
    times["fista_iteration_halo"] = (fista_run[6] - fista_run[1]) / 5
    say("[timing] distributed, median ms over 15 runs after 3 warm-ups, all P ranks on one "
        f"card (not network times), N={n} F={f} eta={filt.eta} M={m} P={n_parts}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()) + f" (grid N={side * side}); kernel time "
        "per call (torch.profiler, 5 calls) and the device's idle share: " + ", ".join(
            f"{k} {busy[k]:.3f} ({1 - busy[k] / times[k]:.0%} idle)" for k in busy))
    return {"errs": errs, "times": times, "busy": busy, "plan_s": plan_s}


def product_shifts(gs, t: int, dev):
    """The two shifts of a time-vertex product of sensor graph ``gs`` and
    a path of ``t`` samples: ``A_G (x) I_T`` along the vertex axis and
    ``I_N (x) A_T`` along the time axis, vertex ``s * t + j`` at (x_s,
    y_s, j / t). Returns the shift graphs and the path's adjacency."""
    import torch

    from repro_torch.core import graph as tgraph

    n = gs.n_vertices
    ones = torch.ones(t - 1, device=dev)
    path = torch.diag(ones, 1) + torch.diag(ones, -1)
    coords = torch.cat([gs.coords.repeat_interleave(t, 0),
                        (torch.arange(t, device=dev) / t).repeat(n)[:, None]], dim=1)
    return [tgraph.SensorGraph(torch.kron(gs.adjacency, torch.eye(t, device=dev)), coords),
            tgraph.SensorGraph(torch.kron(torch.eye(n, device=dev), path), coords)], path


def product_oracle(filt, ag, at, x):
    """Host float64 oracle of a two-shift filter on a time-vertex product:
    ``U_G (vals o (U_G^T X U_T)) U_T^T`` on the (N, T, F) reshape of ``x``
    from the two factor eigendecompositions (no (N T)^2 eigenbasis).
    Returns (eta, N T, F)."""
    import numpy as np

    from repro_torch.core.chebyshev import cheb_eval_joint

    ag, at = (np.asarray(a.cpu().numpy(), np.float64) for a in (ag, at))
    wg, ug = np.linalg.eigh(np.diag(ag.sum(1)) - ag)
    wt, ut = np.linalg.eigh(np.diag(at.sum(1)) - at)
    vals = cheb_eval_joint(filt.coeffs, [np.maximum(wg, 0.0), np.maximum(wt, 0.0)],
                           list(filt.shift_lmaxes))
    xs = x.detach().cpu().numpy().astype(np.float64).reshape(len(wg), len(wt), -1)
    xh = np.einsum("na,ntf,tb->abf", ug, xs, ut, optimize=True)
    return np.stack([np.einsum("na,abf,tb->ntf", ug, vals[j][:, :, None] * xh, ut,
                               optimize=True).reshape(len(wg) * len(wt), -1)
                     for j in range(filt.eta)])


def multishift_phase(dev, count: LaunchCounter, check_union, check_step) -> dict:
    """Phase 8: multi-shift joint filters (``GraphFilter.from_shifts``) on
    a time-vertex product — the tests' small shape, then the full width —
    on dense, bsr (fused and stepwise) and halo against a host float64
    oracle, every apply counted; the bsr adjoint identity and gram; each
    kernel at one innermost call's operands; a two-shift PCG on bsr; and
    the timing of each joint call with its device time and idle share."""
    import numpy as np
    import torch

    from repro_torch import solvers
    from repro_torch.core import chebyshev as tcheb
    from repro_torch.core import graph as tgraph
    from repro_torch.core import multipliers as tmult
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.filters import GraphFilter, shift_matvec_counts
    from repro_torch.kernels import ref as tref

    def err_to(oracle, out):
        return float(np.abs(out.detach().cpu().numpy().astype(np.float64) - oracle).max())

    # The tests' shape: 24 sensors x 6 samples, a heat/Tikhonov bank at
    # M = 8 on the vertex shift, heat at M = 5 on the time shift.
    gs = tgraph.connected_sensor_graph(torch.Generator().manual_seed(7), n=24, sigma=0.45,
                                       kappa=0.5, device=dev)
    shifts, path = product_shifts(gs, 6, dev)
    lms = [float(g.lmax_bound()) for g in shifts]
    small = GraphFilter.from_shifts(shifts, tcheb.separable_joint_coefficients([
        tcheb.cheb_coefficients([tmult.heat(0.6), tmult.tikhonov(1.0, 1)], 8, lms[0]),
        tcheb.cheb_coefficients([tmult.heat(1.2)], 5, lms[1])]), lmaxes=lms)
    x = torch.randn(24 * 6, 3, generator=torch.Generator().manual_seed(8)).to(dev)
    oracle = product_oracle(small, gs.adjacency, path, x)
    small_counts = shift_matvec_counts(small.orders)
    small_errs = {}
    for name, backend, opts, launches in (
            ("dense", "dense", {}, (0, 0)),
            ("bsr", "bsr", {"fuse": True}, (small.orders[0] + 1, 0)),
            ("bsr_stepwise", "bsr", {"fuse": False}, (0, small_counts[1])),
            ("halo", "halo", {"mesh": StackedMesh(N_PARTS, dev)}, (0, 0))):
        out, launched = count(lambda: small.apply(x, backend=backend, **opts))
        expect_launches(f"multishift small {name}", launched, launches)
        small_errs[name] = err_to(oracle, out)
        require(small_errs[name] < MS_SMALL_TOL,
                f"multishift small {name} vs oracle {small_errs[name]:.2e}")
    say(f"[multishift] small N={24 * 6} (24 sensors x 6 samples) orders {small.orders} eta "
        f"{small.eta}: max|x - float64 oracle| " + ", ".join(
            f"{k} {v:.2e}" for k, v in small_errs.items()) + f" (tol {MS_SMALL_TOL:g})")

    # Full width: the Sec. V-B model at 1024 sensors (sigma, kappa scaled
    # by sqrt(500/1024) as in phase 4) x a path of 8 samples, N = 8192.
    t0 = time.perf_counter()
    scale = math.sqrt(PAPER_N / MS_SENSORS)
    gs = tgraph.random_sensor_graph(torch.Generator().manual_seed(21), MS_SENSORS,
                                    0.074 * scale, 0.075 * scale, device=dev)
    shifts, path = product_shifts(gs, MS_T, dev)
    lms = [float(g.lmax_bound()) for g in shifts]
    m1, m2 = MS_ORDERS
    coeffs = tcheb.separable_joint_coefficients([
        tcheb.cheb_coefficients(tmult.sgwt_filter_bank(lms[0], 4), m1, lms[0]),
        tcheb.cheb_coefficients([tmult.heat(1.2)], m2, lms[1])])
    filt = GraphFilter.from_shifts(shifts, coeffs, lmaxes=lms)
    n = MS_SENSORS * MS_T
    signal = torch.randn(n, DEPLOY_F, generator=torch.Generator().manual_seed(22)).to(dev)
    state = filt.prepare_backend("bsr")
    filt.prepare_backend("dense")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mesh = StackedMesh(N_PARTS, dev)
    t0 = time.perf_counter()
    ctx = filt.prepare_backend("halo", mesh=mesh)
    plan_s = time.perf_counter() - t0
    counts = shift_matvec_counts(filt.orders)
    inner = state.bells[-1]
    say(f"[multishift] deploy N={n} ({MS_SENSORS} sensors x {MS_T} samples) F={DEPLOY_F} "
        f"eta={filt.eta} orders {filt.orders} lmaxes {lms[0]:.3f}, {lms[1]:.3f}: |E| vertex "
        f"shift {shifts[0].n_edges} time shift {shifts[1].n_edges}; bsr k_max per shift "
        f"{[b.k_max for b in state.bells]}, nnz tiles {[b.nnz_blocks for b in state.bells]}; "
        f"setup {setup_s:.1f} s; halo plans P={N_PARTS}: halo_words per shift "
        f"{[p.halo_words for p in ctx.plans]}, max_halo {[p.max_halo for p in ctx.plans]}, "
        f"built on the host in {plan_s:.2f} s; shift_matvec_counts {counts}")

    # The counted runs: one joint apply on each route, the adjoint and the gram.
    outs = {}
    mesh.reset_counts()
    for name, call, launches in (
            ("dense", lambda: filt.apply(signal, backend="dense"), (0, 0)),
            ("bsr", lambda: filt.apply(signal, backend="bsr"), (m1 + 1, 0)),
            ("bsr_stepwise", lambda: filt.apply(signal, backend="bsr", fuse=False),
             (0, counts[1])),
            ("halo", lambda: filt.apply(signal, backend="halo", mesh=mesh), (0, 0))):
        out, launched = count(call)
        torch.cuda.synchronize()
        expect_launches(f"multishift deploy {name}", launched, launches)
        require(out.shape == (filt.eta, n, DEPLOY_F) and bool(torch.isfinite(out).all()),
                f"multishift {name} output")
        outs[name] = out
    halo_calls = dict(mesh.calls)
    elements = sum(c * N_PARTS * (N_PARTS - 1) * p.max_halo * DEPLOY_F
                   for c, p in zip(counts, ctx.plans))
    require(halo_calls == {"all_to_all": sum(counts)},
            f"multishift halo exchanges {halo_calls}, want {sum(counts)}")
    require(mesh.elements["all_to_all"] == elements,
            f"multishift halo elements {mesh.elements['all_to_all']}, want {elements}")
    words = filt.messages_per_apply(backend="halo", mesh=mesh)
    want_words = sum(c * p.halo_words for c, p in zip(counts, ctx.plans))
    require(words == want_words, f"multishift halo words {words}, want {want_words}")
    per_shift = [filt.messages_per_apply(orders=o, backend="halo", mesh=mesh)
                 for o in ((m1, 0), (0, m2))]
    require(per_shift == [counts[0] * ctx.plans[0].halo_words,
                          m2 * ctx.plans[1].halo_words], f"per-shift words {per_shift}")
    oracle = product_oracle(filt, gs.adjacency, path, signal)
    errs = {k: err_to(oracle, v) for k, v in outs.items()}
    for k, v in errs.items():
        require(v < AGREE_TOL, f"multishift deploy {k} vs oracle {v:.2e}")
    del oracle
    a = torch.randn(filt.eta, n, DEPLOY_F, generator=torch.Generator().manual_seed(23)).to(dev)
    back, launched = count(lambda: filt.adjoint(a, backend="bsr"))
    expect_launches("multishift bsr adjoint", launched, (0, 0, 0))
    lhs = float((outs["bsr"].double() * a.double()).sum())
    rhs = float((signal.double() * back.double()).sum())
    adj_rel = abs(lhs - rhs) / abs(rhs)
    require(adj_rel <= ADJOINT_RTOL, f"multishift bsr adjoint identity {adj_rel:.2e}")
    gram, launched = count(lambda: filt.gram(signal, backend="bsr"))
    expect_launches("multishift bsr gram", launched, (2 * m1 + 1, 0))
    composed = filt.adjoint(outs["bsr"], backend="bsr")
    gram_err = (gram - composed).abs()
    require(bool((gram_err <= GRAM_TOL + GRAM_TOL * composed.abs()).all()),
            f"multishift bsr gram vs composition {float(gram_err.max()):.2e}")
    say(f"[multishift] deploy max|x - float64 oracle| " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {AGREE_TOL:g}); bsr adjoint "
        f"identity rel {adj_rel:.2e} (rtol {ADJOINT_RTOL:g}); bsr gram vs adjoint(apply) max "
        f"{float(gram_err.max()):.2e} (tol {GRAM_TOL:g}); launches union {m1 + 1} per fused "
        f"apply = prod_(s<R)(M_s+1), {2 * m1 + 1} per gram, step {counts[1]} per stepwise "
        f"apply, 0 on dense, halo and the adjoint; halo {sum(counts)} exchanges per apply "
        f"{halo_calls}, words per apply {words} = sum_r count_r x halo_words_r (vertex shift "
        f"alone {per_shift[0]}, time shift alone {per_shift[1]})")

    # Each kernel at one innermost call's operands: a Krylov vector of the
    # vertex shift (T_1 f in the kernel layout) against an (eta, M_2+1)
    # coefficient slice, on the time shift's tiles.
    fp = torch.nn.functional.pad(signal[state.perm], (0, 0, 0, state.n_pad - n)).contiguous()
    outer = state.bells[0]
    t1 = (tref.bsr_matvec_ref(outer, fp) - (lms[0] / 2.0) * fp) / (lms[0] / 2.0)
    c_slice = np.ascontiguousarray(coeffs[:, 1, :])
    union_err = check_union(inner.blocks, inner.cols, t1, c_slice, lms[1],
                            f"multishift inner eta={filt.eta} M={m2}")
    step_err = check_step(inner.blocks, inner.cols, t1, fp, lms[1] / 2.0, "multishift inner")

    # A two-shift PCG on bsr: one column, reg 1e-3, the joint fit from order 6.
    b = signal[:, :1].contiguous()
    prob = solvers.GramProblem(filt=filt, b=b, reg=1e-3)
    pre = solvers.cheb_preconditioner(prob, order=6, backend="bsr")
    require(pre.rate < 1.0, f"multishift preconditioner rate {pre.rate:.4f}")
    k1 = pre.orders[0]
    pcg, launched = count(lambda: solvers.conjugate_gradient(
        prob, n_iters=300, tol=SOLVER_TOL, backend="bsr", preconditioner=pre))
    require(pcg.converged, f"multishift pcg did not converge ({pcg.history[-1]:.2e})")
    expect_launches("multishift pcg", launched, ((pcg.iterations + 1) * (2 * m1 + 1 + k1 + 1), 0))
    cg, launched = count(lambda: solvers.conjugate_gradient(prob, n_iters=1000, tol=SOLVER_TOL,
                                                         backend="bsr"))
    expect_launches("multishift cg", launched, ((cg.iterations + 1) * (2 * m1 + 1), 0))
    require(cg.converged and pcg.iterations < cg.iterations,
            f"multishift cg {cg.iterations} ({cg.converged}), pcg {pcg.iterations}")
    scale_x = float(cg.x.abs().max())
    d_x = float((pcg.x - cg.x).abs().max())
    say(f"[multishift] deploy two-shift PCG on bsr, one column, reg 1e-3 tol {SOLVER_TOL:g}: "
        f"fit orders {pre.orders} rate {pre.rate:.4f}, {pcg.iterations} iterations (plain CG "
        f"{cg.iterations}), max|x_pcg - x_cg| {d_x:.2e} of max|x| {scale_x:.1f}; launches union "
        f"(iterations + 1) x ({2 * m1 + 1} + {k1 + 1}) and (iterations + 1) x {2 * m1 + 1}")
    return {"filt": filt, "signal": signal, "a": a, "mesh": mesh, "state": state,
            "union_err": union_err, "step_err": step_err, "t1": t1, "c_slice": c_slice,
            "lmax_inner": lms[1], "errs": errs, "pcg": pcg.iterations, "cg": cg.iterations}


def synchronising_ops(fn) -> int:
    """Synchronising CUDA operations in one call of ``fn`` (a blocking
    host-to-device copy is one), counted by ``torch.cuda``'s sync debug
    mode, which warns at each."""
    import torch

    fn()
    torch.cuda.synchronize()
    return synchronising_ops_once(fn)


def synchronising_ops_once(fn) -> int:
    """``synchronising_ops`` without the warm-up call."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature and does not yet detect
    # all synchronizing operations") is no synchronising operation
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
               for w in caught)


def multishift_timing(ms: dict) -> dict:
    """Median CUDA-event ms of each joint call at full width, its kernel
    time per call from ``torch.profiler`` and the device's idle share, and
    the union kernel alone at one innermost call's operands beside its
    plain version and bound."""
    import numpy as np
    import torch

    from repro_torch.kernels import cheb_bsr, ref as tref

    filt, signal, a, mesh = ms["filt"], ms["signal"], ms["a"], ms["mesh"]
    calls = {
        "dense": lambda: filt.apply(signal, backend="dense"),
        "bsr": lambda: filt.apply(signal, backend="bsr"),
        "bsr_stepwise": lambda: filt.apply(signal, backend="bsr", fuse=False),
        "halo": lambda: filt.apply(signal, backend="halo", mesh=mesh),
        "bsr_adjoint": lambda: filt.adjoint(a, backend="bsr"),
        "bsr_gram": lambda: filt.gram(signal, backend="bsr"),
    }
    reps = {"dense": 5, "bsr_adjoint": 7}
    times = {k: median_ms(fn, reps=reps.get(k, 15)) for k, fn in calls.items()}
    busy = {k: device_busy_ms(fn, runs=3) for k, fn in calls.items()}
    # The count sees a blocking upload (the control), and a joint bsr call
    # makes none: its coefficients are on the card once per tensor.
    control = synchronising_ops(lambda: torch.as_tensor(np.ones(4), device=signal.device))
    syncs = {k: synchronising_ops(fn) for k, fn in calls.items()}
    require(control >= 1, f"the sync count missed a blocking upload ({control})")
    require(syncs["bsr"] == syncs["bsr_stepwise"] == syncs["bsr_gram"] == syncs["bsr_adjoint"]
            == 0, f"synchronising operations in a joint bsr call: {syncs}")
    inner, t1, c, lm = ms["state"].bells[-1], ms["t1"], ms["c_slice"], ms["lmax_inner"]
    kernel_ms = median_ms(lambda: cheb_bsr.cheb_union_cuda(inner.blocks, inner.cols, t1,
                                                           coeffs=c, lmax=lm))
    plain_ms = median_ms(lambda: tref.cheb_union_ref(inner.blocks, inner.cols, t1, c, lm))
    nnz = int(torch.count_nonzero(inner.blocks))
    tiles = inner.blocks.numel() * 4 + inner.cols.numel() * 4
    ib, ib_by = bound(*union_work(nnz, tiles, t1.shape[0], t1.shape[1], c.shape[0],
                                  c.shape[1] - 1))
    launches = filt.orders[0] + 1
    say(f"[timing] multishift, median ms at N={signal.shape[0]} F={signal.shape[1]} "
        f"eta={filt.eta} orders {filt.orders}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()) + "; kernel time per call "
        "(torch.profiler, 3 calls) and the device's idle share: " + ", ".join(
            f"{k} {busy[k]:.3f} ({1 - busy[k] / times[k]:.0%} idle)" for k in busy)
        + f"; synchronising operations per call (sync debug mode; a blocking upload "
        f"counts {control}): " + ", ".join(f"{k} {v}" for k, v in syncs.items())
        + f"; union kernel at one innermost call (eta={c.shape[0]}, M={c.shape[1] - 1}, "
        f"{launches} per joint apply) {kernel_ms:.4f} ms, plain {plain_ms:.3f}, bound "
        f"{ib:.4f} by {ib_by}")
    return {"times": times, "busy": busy, "syncs": syncs, "inner_ms": kernel_ms, "inner_plain_ms": plain_ms,
            "inner_bound_ms": ib, "inner_bound_by": ib_by}


def push_series(make_lane, steps, count: LaunchCounter, check=None):
    """Drive ``steps`` ((frame, delta) pairs) through fresh lanes from
    ``make_lane`` three times. (1) Timed and counted: CUDA events around
    each push, its host-side ms (``FrameResult.host_s``: the reach BFS,
    and on a topology delta the patch, tracker and plan repair), its
    launches; ``check(i, result)`` runs after each push, outside the
    timing. (2) Profiled: the device kernel time of the pushes after the
    first (the cold full frame). (3) The synchronising operations of each
    push. Returns ``(records, lane of run 1, busy_ms)``."""
    import torch

    lane = make_lane()
    recs = []
    for i, (y, delta) in enumerate(steps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res, launched = count(lambda: lane.push(y, delta=delta))
        stop.record()
        stop.synchronize()
        recs.append({"mode": res.mode, "changed": res.changed, "active": res.active,
                     "words": res.words, "ms": start.elapsed_time(stop),
                     "host_ms": res.host_s * 1e3, "union": launched[0], "step": launched[1]})
        if check is not None:
            check(i, res)
    replay = make_lane()
    y0, delta0 = steps[0]
    replay.push(y0, delta=delta0)
    busy = kernel_ms_once(lambda: [replay.push(y, delta=d) for y, d in steps[1:]])
    replay = make_lane()
    for rec, (y, delta) in zip(recs, steps):
        rec["syncs"] = synchronising_ops_once(lambda: replay.push(y, delta=delta))
    return recs, lane, busy


def series_summary(recs, busy: float) -> str:
    """One line's worth of a push series: per push mode, active, ms,
    host-side ms and syncs, then the medians and the device's idle share
    over the pushes after the first (the cold full frame)."""
    tail = recs[1:]
    total = sum(r["ms"] for r in tail)
    per = "; ".join(f"{r['mode']} a={r['active']} {r['ms']:.3f} ms host {r['host_ms']:.3f} "
                    f"syncs {r['syncs']}" for r in recs)
    return (f"{per} || median push {statistics.median(r['ms'] for r in tail):.3f} ms, host-side "
            f"share {sum(r['host_ms'] for r in tail) / total:.0%}, device idle share "
            f"{max(0.0, 1 - busy / total):.0%} (kernels {busy:.3f} of {total:.3f} ms), syncs per "
            f"push {statistics.median(r['syncs'] for r in tail):g}")


def stream_phase(dev, count: LaunchCounter, deploy_filt, deploy_signal, check_union=None) -> dict:
    """Phase 9: the streaming lane and topology churn. (a) The
    ``tab_streaming`` cell at its own shape, held to ``BENCH_pr10.json``
    exactly, on dense and on bsr (union launches exact), and its 2 % frame
    at F = 256 timed beside full refilters; (b) the deployment shape:
    compact 2 % patches on dense and bsr, and a warm-started
    ``StreamingLasso`` on bsr at the paper shape; (c) the ``tab_churn``
    cell (convoy scenario) against a host-evolved dense oracle, then at
    F = 256. Every push is counted. ``check_union`` (optional) holds the
    union kernel against its plain version at the grid stream's operands,
    F = 1 and F = 256; ``out["union_err"]`` is its worst error."""
    import numpy as np
    import torch

    from repro_torch import solvers
    from repro_torch.core import chebyshev as tcheb
    from repro_torch.core import distributed as tdist
    from repro_torch.core import graph as tgraph
    from repro_torch.core import multipliers as tmult
    from repro_torch.dynamic import apply_delta_inplace, kernel_trace_counts
    from repro_torch.dynamic import mobile_sensor_scenario
    from repro_torch.filters import GraphFilter
    from repro_torch.stream import StreamingFilter, StreamingLasso

    def err(a, b):
        return float((a - b).abs().max())

    def upload(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    out = {}
    # ---- (a) tab_streaming: benchmarks/run.py:534-590, at its own shape ----
    side = STREAM_SIDE
    gg = tgraph.grid_graph(side, device=dev)
    gfilt = GraphFilter.from_multipliers([tmult.tikhonov(1.0, 1)], STREAM_ORDER, graph=gg, lmax=8.0)
    c = gg.coords.cpu().numpy()
    f0 = (c[:, 0] ** 2 + c[:, 1] ** 2).astype(np.float32)
    rng = np.random.default_rng(11)
    patches = {}
    for patch in STREAM_RECORD:
        y = f0.copy()
        r0, c0 = rng.integers(0, side - patch, size=2)
        rr, cc = np.meshgrid(np.arange(r0, r0 + patch), np.arange(c0, c0 + patch), indexing="ij")
        ch = (rr * side + cc).ravel()
        y[ch] += rng.normal(size=len(ch)).astype(np.float32) * 0.3
        patches[patch] = (y, ch)
    f0_t = upload(f0)
    t0 = time.perf_counter()
    lane = StreamingFilter(gfilt, backend="dense", n_parts=STREAM_PARTS, max_delta_frac=0.5,
                           device=dev)
    plan_s = time.perf_counter() - t0
    first, launched = count(lambda: lane.push(f0_t))
    expect_launches("stream grid full frame dense", launched, (0, 0))
    require(first.mode == "full" and first.words == lane._full_words() == STREAM_FULL_WORDS,
            f"tab_streaming full words {first.words}, want {STREAM_FULL_WORDS}")
    rows = []
    for patch, want in STREAM_RECORD.items():
        y_t = upload(patches[patch][0])
        lane.reset()
        lane.push(f0_t)
        res, launched = count(lambda: lane.push(y_t))
        expect_launches(f"stream grid delta patch {patch} dense", launched, (0, 0))
        parity = err(res.out, gfilt.apply(y_t, backend="dense"))
        got = (res.changed, res.active, res.words)
        require(res.mode == "delta" and got == want,
                f"tab_streaming patch {patch}: {res.mode} {got}, record {want}")
        require(parity <= STREAM_TOL, f"tab_streaming patch {patch} parity {parity:.2e}")
        rows.append(f"c{round(100 * patch * patch / (side * side)):02d} {got} parity {parity:.1e}")
    say(f"[stream] tab_streaming N={side * side} grid, Tikhonov M={STREAM_ORDER} lmax 8, "
        f"P={STREAM_PARTS} (plan on the host {plan_s:.2f} s): full words/frame "
        f"{first.words} (record {STREAM_FULL_WORDS}); (changed, active, words) per patch, "
        f"mode delta, parity vs full dense (tol {STREAM_TOL:g}): " + "; ".join(rows)
        + " = the record")

    # The same stream on bsr (fused): union launches 1 per full or delta
    # frame, 0 per cached frame; each frame against the full dense apply.
    frames = [f0] + [patches[p][0] for p in STREAM_RECORD]
    frames.insert(2, frames[1])  # a repeated frame: the cache answers
    blane = StreamingFilter(gfilt, backend="bsr", max_delta_frac=0.5, device=dev)
    bsr_rows, bsr_err = [], 0.0
    for y in frames:
        y_t = upload(y)
        res, launched = count(lambda: blane.push(y_t))
        want = (0, 0) if res.mode == "cached" else (1, 0)
        expect_launches(f"stream grid bsr {res.mode} frame", launched, want)
        bsr_err = max(bsr_err, err(res.out, gfilt.apply(y_t, backend="dense")))
        bsr_rows.append(f"{res.mode} {launched[0]}")
    require([r.split()[0] for r in bsr_rows] == ["full", "delta", "cached", "delta", "delta",
                                                 "delta"], f"bsr stream modes {bsr_rows}")
    require(bsr_err <= BSR_DENSE_TOL, f"bsr stream vs dense {bsr_err:.2e}")
    say(f"[stream] tab_streaming on bsr (fused): mode and union launches per frame "
        f"{', '.join(bsr_rows)}; max|out - full dense| {bsr_err:.2e} (tol {BSR_DENSE_TOL:g})")

    # c02 timed, at F = 1 (the record's frame) and at F = STREAM_F columns
    # (the same changed rows, seeded gains per column): alternating frames,
    # so every push after the first is a delta frame over those rows; each
    # beside a full refilter.
    y02, ch02 = patches[11]
    gains = np.random.default_rng(12).uniform(0.5, 1.5, STREAM_F).astype(np.float32)
    wide = f0[:, None] * gains[None, :]
    wide_y = wide.copy()
    wide_y[ch02] += 0.3 * np.random.default_rng(13).normal(size=(len(ch02), STREAM_F)).astype(
        np.float32)
    timing = {}
    out["union_err"] = 0.0
    gbell = gfilt.prepare_backend("bsr").bell
    require(gbell.n == side * side, f"grid bsr operands pad N to {gbell.n}")
    for width, (base, changed) in ((1, (f0, y02)), (STREAM_F, (wide, wide_y))):
        base_t, changed_t = upload(base), upload(changed)
        if check_union is not None:
            col = changed_t if width > 1 else changed_t[:, None]
            out["union_err"] = max(out["union_err"], check_union(
                gbell.blocks, gbell.cols, col, gfilt.coeffs, gfilt.lmax,
                f"stream grid eta={gfilt.eta} M={STREAM_ORDER} F={width}"))
        steps = [(base_t, None)] + [(changed_t, None), (base_t, None)] * STREAM_REPEATS
        # every push against the full dense apply of its frame (frames
        # alternate base, changed): the bsr stream's union kernel is held
        # to the plain dense recurrence, not to another union apply
        wants = [gfilt.apply(x, backend="dense") for x in (base_t, changed_t)]
        for backend in ("dense", "bsr"):
            tol = STREAM_TOL if backend == "dense" else BSR_DENSE_TOL
            worst = [0.0]

            def check(i, res, backend=backend, width=width, tol=tol, worst=worst):
                e = err(res.out, wants[i % 2])
                require(e <= tol, f"c02 F={width} {backend} frame {i} vs full dense {e:.2e} "
                        f"(tol {tol:g})")
                worst[0] = max(worst[0], e)

            recs, _, busy = push_series(
                lambda b=backend: StreamingFilter(gfilt, backend=b, max_delta_frac=0.5,
                                                  device=dev), steps, count, check)
            want = 1 if backend == "bsr" else 0
            require(all(r["union"] == want and r["step"] == 0 for r in recs),
                    f"c02 F={width} {backend} launches {[r['union'] for r in recs]}")
            require([r["mode"] for r in recs] == ["full"] + ["delta"] * (2 * STREAM_REPEATS),
                    f"c02 F={width} {backend} modes")
            full_ms = median_ms(lambda b=backend, y=changed_t: gfilt.apply(y, backend=b))
            timing[(width, backend)] = {"recs": recs, "busy": busy, "full_ms": full_ms}
            say(f"[timing] stream c02 N={side * side} F={width} {backend}: every push vs full "
                f"dense {worst[0]:.2e} (tol {tol:g}); full refilter {full_ms:.3f} ms (median "
                f"of 15); per push: " + series_summary(recs, busy))
    out["grid"] = timing

    # ---- (b) the deployment shape -------------------------------------------
    n, f = deploy_signal.shape
    coords = deploy_filt.graph.coords.cpu().numpy()
    rng = np.random.default_rng(17)
    n_patch = round(0.02 * n)
    y = deploy_signal.cpu().numpy()
    dframes = [deploy_signal]
    for _ in range(DEPLOY_STREAM_FRAMES):
        centre = coords[rng.integers(n)]
        disk = np.argsort(((coords - centre) ** 2).sum(axis=1))[:n_patch]
        y = y.copy()
        y[disk] += 0.3 * rng.normal(size=(n_patch, f)).astype(np.float32)
        dframes.append(upload(y))
    dsteps = [(x, None) for x in dframes]
    want_final = deploy_filt.apply(dframes[-1], backend="dense")
    deploy = {}
    for backend in ("dense", "bsr"):
        final = {}

        def keep(i, res, final=final):
            if i == len(dsteps) - 1:
                final["out"] = res.out

        recs, _, busy = push_series(
            lambda b=backend: StreamingFilter(deploy_filt, backend=b, device=dev), dsteps, count,
            keep)
        want = 1 if backend == "bsr" else 0
        require(all(r["union"] == want and r["step"] == 0 for r in recs),
                f"deploy stream {backend} launches {[r['union'] for r in recs]}")
        require([r["mode"] for r in recs] == ["full"] + ["delta"] * DEPLOY_STREAM_FRAMES,
                f"deploy stream {backend} modes {[r['mode'] for r in recs]}")
        e = err(final["out"], want_final)
        require(e < AGREE_TOL, f"deploy stream {backend} final vs full dense {e:.2e}")
        deploy[backend] = {"recs": recs, "busy": busy, "err": e}
        say(f"[stream] deploy N={n} F={f} eta={deploy_filt.eta} M={deploy_filt.order} "
            f"{backend}: {DEPLOY_STREAM_FRAMES} frames, each a seeded disk of {n_patch} vertices "
            f"(2 %); final out vs full dense {e:.2e} (tol {AGREE_TOL:g}); union launches per "
            f"push {[r['union'] for r in recs]}; per push: " + series_summary(recs, busy))
    out["deploy"] = deploy

    # A warm-started StreamingLasso (FISTA, tol) on bsr at the paper shape:
    # three frames, each changing 2 % of the vertices; frame 0 is the
    # lane's cold solve, frames 1 and 2 run beside a cold solve of the
    # same frame (warm iterations <= cold). The lane stops on the
    # objective's relative change, and at mu = 2 FISTA's objective ripples
    # down a long tail, so a stop fires near a ripple's turning point: the
    # warm stop's objective is reported beside the cold one, not bounded
    # (it lands a few % to tens of % above it, and drifts over frames).
    # The equal answer is held as the reference's test holds it
    # (tests/test_stream.py:275-286): seeded with the previous frame's
    # cold solution, a budget-mode FISTA reaches the cold solve's final
    # objective. Its budget is half the cold iterations, not the test's
    # quarter: the CPU rehearsal crossed at 237 and 1745 of ~8600.
    gen = torch.Generator().manual_seed(42)
    pg = tgraph.connected_sensor_graph(gen, n=PAPER_N, device=dev)
    pf0 = pg.coords[:, 0] ** 2 + pg.coords[:, 1] ** 2 - 1.0
    py = (pf0 + 0.5 * torch.randn(pf0.shape, generator=gen).to(dev)).cpu().numpy()
    plmax = float(pg.lmax_bound())
    pfilt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(plmax, PAPER_SCALES), ORDER,
                                         graph=pg, lmax=plmax)
    rng = np.random.default_rng(23)
    lasso_frames = [py]
    for _ in range(2):
        y = lasso_frames[-1].copy()
        ch = rng.choice(PAPER_N, size=PAPER_N // 50, replace=False)
        y[ch] += 0.3 * rng.normal(size=len(ch)).astype(np.float32)
        lasso_frames.append(y)
    slane = StreamingLasso(pfilt, method="fista", mu=PAPER_MU, n_iters=LASSO_BUDGET,
                           tol=LASSO_TOL, backend="bsr", device=dev)
    lasso_rows, prev_cold = [], None
    for i, y in enumerate(lasso_frames):
        y_t = upload(y)
        warm, launched = count(lambda: slane.push(y_t))
        # a warm solve starts from the carried coefficients: no a0 = Phi~ y
        expect_launches(f"streaming lasso frame {i}", launched, (warm.iterations + (i == 0), 0))
        problem = solvers.LassoProblem(filt=pfilt, y=y_t, mu=PAPER_MU)
        if i == 0:
            require(warm.converged, f"streaming lasso cold frame: {warm.iterations} iterations")
            lasso_rows.append(f"frame 0 (cold): {warm.iterations} (objective "
                              f"{problem.objective(warm.aux):.4f})")
            prev_cold = warm.aux
            continue
        cold, launched = count(lambda: solvers.fista(problem, n_iters=LASSO_BUDGET, tol=LASSO_TOL,
                                                  backend="bsr"))
        expect_launches(f"cold lasso frame {i}", launched, (cold.iterations + 1, 0))
        ow, oc = float(problem.objective(warm.aux)), float(problem.objective(cold.aux))
        require(warm.converged and cold.converged and warm.iterations <= cold.iterations,
                f"streaming lasso frame {i}: warm {warm.iterations} cold {cold.iterations}")
        budget = cold.iterations // 2
        seeded, launched = count(lambda: solvers.fista(problem, a0=prev_cold, n_iters=budget,
                                                    backend="bsr"))
        expect_launches(f"seeded lasso frame {i}", launched, (budget, 0))
        target = float(cold.history[-1]) * (1.0 + 1e-6)
        hit = np.nonzero(seeded.history <= target)[0]
        require(hit.size > 0, f"streaming lasso frame {i}: seeded FISTA did not reach the cold "
                f"objective {target:.4f} in {budget} iterations (min {seeded.history.min():.4f})")
        prev_cold = cold.aux
        lasso_rows.append(f"frame {i}: warm {warm.iterations} (objective {ow:.4f}) cold "
                          f"{cold.iterations} ({oc:.4f}; warm / cold {ow / oc:.4f}); seeded "
                          f"FISTA reaches the cold objective at iteration {int(hit[0]) + 1} of "
                          f"{budget}")
    say(f"[stream] StreamingLasso FISTA mu={PAPER_MU} tol {LASSO_TOL:g} budget {LASSO_BUDGET} on "
        f"bsr, paper N={PAPER_N} eta={pfilt.eta} M={ORDER}, frames changing 2 %: "
        + "; ".join(lasso_rows) + "; union launches iterations + 1 per cold solve, iterations "
        "per warm or seeded solve (exact)")

    # ---- (c) tab_churn: benchmarks/run.py:727-800 ----------------------------
    t0 = time.perf_counter()
    sc = mobile_sensor_scenario(CHURN_SLOTS, CHURN_FRAMES, mobility="convoy", seed=7,
                                cluster_radius=0.07, speed=0.012, birth_rate=0.2,
                                death_rate=0.2, bump_radius=0.12, device=dev)
    gen_s = time.perf_counter() - t0
    require(round(sc.mean_churn, 4) == CHURN_MEAN,
            f"churn scenario mean_churn {sc.mean_churn:.4f}, record {CHURN_MEAN}")
    g0 = sc.graph0
    cfilt = GraphFilter.from_multipliers([tmult.heat(1.0), lambda x: x / (1.0 + x)],
                                         CHURN_ORDER, graph=g0, lmax=1.5 * float(g0.lmax_bound()))
    coeffs32 = np.asarray(cfilt.coeffs, np.float32)
    churn = {}
    for width in (1, STREAM_F):
        if width == 1:
            sig = [upload(fr.signal) for fr in sc.frames]
            tol = STREAM_TOL
        else:
            cg = np.random.default_rng(29).uniform(0.5, 1.5, width).astype(np.float32)
            sig = [upload(fr.signal[:, None] * cg[None, :]) for fr in sc.frames]
            tol = AGREE_TOL
        csteps = [(s, fr.delta) for s, fr in zip(sig, sc.frames)]
        adj = g0.adjacency.cpu().numpy().copy()
        lap = np.diag(adj.sum(axis=1)) - adj
        xy = g0.coords.cpu().numpy().copy()
        oracle = {"plan": tdist.build_partition_plan(adj, xy, CHURN_PARTS, device="cpu"),
                  "parity": 0.0, "full_words": [], "repair_ms": [], "rebuild_ms": [],
                  "mid": None}
        mid = 1 + (len(csteps) - 1) // 2

        def check(i, res, adj=adj, lap=lap, oracle=oracle, sig=sig, tol=tol, width=width):
            fr = sc.frames[i]
            if fr.delta is not None:
                apply_delta_inplace(adj, lap, fr.delta)
                t1 = time.perf_counter()
                oracle["plan"] = tdist.repair_partition_plan(oracle["plan"], adj,
                                                             fr.delta.touched)
                t2 = time.perf_counter()
                fresh = tdist.build_partition_plan(adj, fr.delta.coords, CHURN_PARTS,
                                                   device="cpu")
                t3 = time.perf_counter()
                oracle["repair_ms"].append((t2 - t1) * 1e3)
                oracle["rebuild_ms"].append((t3 - t2) * 1e3)
                oracle["full_words"].append(CHURN_ORDER * fresh.halo_words)
            want = tcheb.cheb_apply_dense(upload(lap.astype(np.float32)), sig[i], coeffs32,
                                          cfilt.lmax)
            e = err(res.out, want)
            require(e <= tol, f"churn F={width} frame {i} ({res.mode}) vs oracle {e:.2e}")
            oracle["parity"] = max(oracle["parity"], e)
            if i == mid:
                oracle["mid"] = sum(kernel_trace_counts().values())
            if i == len(csteps) - 1:
                oracle["end"] = sum(kernel_trace_counts().values())

        recs, clane, busy = push_series(
            lambda: StreamingFilter(cfilt, backend="dense", n_parts=CHURN_PARTS,
                                    max_delta_frac=0.9, device=dev), csteps, count, check)
        retraces = oracle["end"] - oracle["mid"]
        replayed = sum(kernel_trace_counts().values()) - oracle["end"]
        modes = [r["mode"] for r in recs[1:]]
        words = [r["words"] for r in recs[1:]]
        require(all(r["union"] == 0 and r["step"] == 0 for r in recs), "churn launched a kernel")
        require(len(modes) == CHURN_FRAMES - 1 and modes.count("churn") == CHURN_FRAMES - 2,
                f"churn F={width} modes {modes}")
        require(clane.reexpansions == 0, f"churn re-expansions {clane.reexpansions}")
        require(CHURN_WORDS_SUM[0] <= sum(words) <= CHURN_WORDS_SUM[1],
                f"churn words {words} sum {sum(words)}, record window {CHURN_WORDS_SUM}")
        full_mean = float(np.mean(oracle["full_words"]))
        require(round(full_mean) == CHURN_FULL_WORDS_MEAN,
                f"churn fresh-plan words mean {full_mean:.1f}, record {CHURN_FULL_WORDS_MEAN}")
        require(retraces == 0 and replayed == 0,
                f"churn: {retraces} new kernel keys over the second half, {replayed} in replays")
        require(clane._tk.device == dev and clane._lap_dev.device == dev,
                "the churn state left the card")
        tk_mb = clane._tk.numel() * clane._tk.element_size() / 2**20
        churn[width] = {"recs": recs, "busy": busy, "parity": oracle["parity"],
                        "words": words, "tk_mb": tk_mb}
        say(f"[churn] convoy N={CHURN_SLOTS} F={width} M={CHURN_ORDER} P={CHURN_PARTS} "
            f"(scenario {gen_s:.2f} s on the host): mean_churn {sc.mean_churn:.4f} (record "
            f"{CHURN_MEAN}); modes {modes}; re-expansions {clane.reexpansions}; words per frame "
            f"{words}, sum {sum(words)} (record window {CHURN_WORDS_SUM[0]}-{CHURN_WORDS_SUM[1]}),"
            f" mean {np.mean(words):.1f} against the fresh plans' {full_mean:.1f} (record "
            f"{CHURN_FULL_WORDS_MEAN}); parity vs the float32 dense oracle {oracle['parity']:.2e} "
            f"(tol {tol:g}); new kernel keys over the second half {retraces}; Krylov stack on the "
            f"card {tk_mb:.2f} MiB; host plan repair median "
            f"{statistics.median(oracle['repair_ms']):.2f} ms vs rebuild "
            f"{statistics.median(oracle['rebuild_ms']):.2f} ms")
        say(f"[timing] churn F={width} per push: " + series_summary(recs, busy))
    out["churn"] = churn
    return out


def make_trace(n_streams: int, seconds: float, rate: float, *, seed: int = 0,
               hot_frac: float = 0.01, hot_mass: float = 0.5,
               lane_mix=(0.90, 0.08, 0.02), n_tenants: int = 8, n_signals: int = 64,
               burst: bool = False) -> dict:
    """A numpy copy of ``benchmarks/loadgen.py::make_trace`` (:67-118):
    Poisson arrivals at ``rate`` over ``seconds`` (all at t = 0 when
    ``burst``), ``hot_frac`` of the streams carrying ``hot_mass`` of the
    requests, lanes drawn from ``lane_mix``; the same draws in the same
    order, so the same seed gives the same trace."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_requests = max(1, int(round(rate * seconds)))
    if burst:
        t_arrive = np.zeros(n_requests)
    else:
        t_arrive = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    n_hot = max(1, int(round(hot_frac * n_streams)))
    is_hot = rng.random(n_requests) < hot_mass
    hot_ids = rng.integers(0, n_hot, n_requests)
    cold_ids = (rng.integers(0, max(n_streams - n_hot, 1), n_requests) + n_hot).clip(
        max=n_streams - 1)
    stream = np.where(is_hot, hot_ids, cold_ids)
    mix = np.asarray(lane_mix, np.float64)
    lane = rng.choice(3, size=n_requests, p=mix / mix.sum())
    return {"t_arrive": t_arrive, "stream": stream.astype(np.int64), "lane": lane.astype(np.int8),
            "tenant": (stream % n_tenants).astype(np.int64),
            "signal": rng.integers(0, n_signals, n_requests)}


def signal_pool(n_vertices: int, n_signals: int, seed: int = 0):
    """``benchmarks/loadgen.py::make_signal_pool``: the (n_signals, N)
    float32 payloads the trace's requests index into."""
    import numpy as np

    return np.random.default_rng(seed + 1).normal(size=(n_signals, n_vertices)).astype(np.float32)


def drive_async(engine, trace: dict, pool, frame_streams: int) -> dict:
    """Replay ``trace`` against an ``AsyncGraphFilterEngine`` on its
    virtual clock, as ``benchmarks/loadgen.py::_drive_async`` does: between
    arrivals every lane whose deadline falls in the gap is pumped, frames
    fold onto ``frame_streams`` engine streams. Returns the run's served
    and rejected counts, per-lane latencies and the deltas of the
    engine's counters."""
    import numpy as np

    from repro_torch.serve import LANES, AdmissionError

    base = engine.stats()
    base_pad, base_slots = engine.pad_slots, engine.panel_slots
    engine.reset_clock()  # a fresh virtual timeline per replay

    def pump(t_now):
        while True:
            due = [d for lane in LANES
                   if (d := engine.scheduler.oldest_deadline(lane)) is not None and d <= t_now]
            if not due:
                return
            engine.step(now=min(due))

    tickets, rejected = [], 0
    t_arrive = trace["t_arrive"]
    for i in range(len(t_arrive)):
        t = float(t_arrive[i])
        pump(t)
        sig = pool[trace["signal"][i]]
        tenant = f"t{trace['tenant'][i]}"
        code = int(trace["lane"][i])
        try:
            if code == 0:
                tk = engine.submit(sig, tenant=tenant, now=t)
            elif code == 1:
                tk = engine.submit_solve(sig, tenant=tenant, now=t)
            else:
                tk = engine.submit_frame(int(trace["stream"][i]) % frame_streams, sig,
                                         tenant=tenant, now=t)
            tickets.append(tk)
        except AdmissionError:
            rejected += 1
        engine.step(now=t)
    t = float(t_arrive[-1])
    while engine.scheduler.pending():
        due = [d for lane in LANES if (d := engine.scheduler.oldest_deadline(lane)) is not None]
        t = max(t, min(due))
        engine.step(now=t)
    after = engine.stats()
    slots = engine.panel_slots - base_slots
    return {
        "requests": len(t_arrive), "served": sum(tk.done for tk in tickets),
        "rejected": rejected,
        "lat": {lane: np.asarray([tk.latency_s for tk in tickets if tk.lane == lane and tk.done])
                for lane in LANES},
        "busy_s": after["busy_s"] - base["busy_s"],
        "makespan_s": max(engine.busy_until, t) - float(t_arrive[0]),
        **{k: after[k] - base[k] for k in ("recompiles", "captures", "replays", "applies",
                                           "solves", "frames_served", "streams_evicted")},
        "frames_filtered": sum(tk.result.mode != "cached" for tk in tickets if tk.lane == "frame"),
        "pad_waste": (engine.pad_slots - base_pad) / max(slots, 1),
    }


def drive_sync(engine, trace: dict, pool, frame_streams: int) -> dict:
    """Replay ``trace`` against a ``GraphFilterEngine``, as
    ``benchmarks/loadgen.py::_drive_sync`` does: a lane's callers block
    until its fixed-width panel fills, each flush is stamped on the same
    single-server virtual timeline. Returns served, busy seconds and the
    latencies."""
    import numpy as np

    busy_until, busy_s, lat = 0.0, 0.0, []
    pending = {0: [], 1: [], 2: []}

    def complete(code, t_now, dt):
        nonlocal busy_until, busy_s
        busy_until = max(t_now, busy_until) + dt
        busy_s += dt
        lat.extend(busy_until - ts for ts in pending[code])
        pending[code].clear()

    for i in range(len(trace["t_arrive"])):
        t = float(trace["t_arrive"][i])
        sig = pool[trace["signal"][i]]
        code = int(trace["lane"][i])
        t0 = time.perf_counter()
        if code == 0:
            out = engine.submit(sig)
        elif code == 1:
            out = engine.submit_solve(sig)
        else:
            out = engine.submit_frame(int(trace["stream"][i]) % frame_streams, sig)
        dt = time.perf_counter() - t0
        pending[code].append(t)
        if out is not None:
            complete(code, t, dt)
    t_end = float(trace["t_arrive"][-1])
    for code, flush in ((0, engine.flush), (1, engine.flush_solves), (2, engine.flush_frames)):
        if pending[code]:
            t0 = time.perf_counter()
            flush()
            complete(code, t_end, time.perf_counter() - t0)
    return {"served": len(lat), "busy_s": busy_s, "lat": np.asarray(lat)}


def pct_ms(lat) -> str:
    """p50 / p99 of latencies in seconds, as milliseconds."""
    import numpy as np

    if len(lat) == 0:
        return "none"
    return f"p50 {np.percentile(lat, 50) * 1e3:.3f} p99 {np.percentile(lat, 99) * 1e3:.3f} ms"


def serve_phase(dev, count: LaunchCounter, deploy_filt) -> dict:
    """Phase 10: the serving layer at the deployment shape (phase 4's
    filter on bsr). (1) One ``panel_program`` per bucket, each recorded
    as one CUDA graph, against eager and solo applies and dense; each
    kernel inside a recorded graph against its plain version; one
    stepwise program; the FISTA solve programs. (2) The sync engine on
    each lane, against solo calls. (3) The async engine on a seeded trace,
    paced (warm, then measured) and in a burst, beside the sync engine.
    Every engine and program run is counted (``count``)."""
    import numpy as np
    import torch

    from repro_torch.device import upload
    from repro_torch.filters import CudaGraphProgram
    from repro_torch.kernels import cheb_bsr, ref as tref
    from repro_torch.serve import (
        AsyncGraphFilterEngine,
        GraphFilterEngine,
        SchedulerConfig,
        lasso_panel_solver,
    )
    from repro_torch.serve.engine import host_copy, solve_answers
    from repro_torch.solvers import LassoProblem, fista
    from repro_torch.stream import StreamingFilter

    t_phase = time.perf_counter()
    filt = deploy_filt
    n = filt.graph.n_vertices
    state = filt.prepare_backend("bsr")
    bell = state.bell
    lmax = filt.lmax
    pool = signal_pool(n, 64)
    out = {"union_err": 0.0, "step_err": 0.0}

    def err(a, b):
        return float((a - b).abs().max())

    def pack(rows, b):
        panel = np.stack(list(rows), axis=1)
        return np.pad(panel, ((0, 0), (0, b - panel.shape[1])))

    def memory_flat(run, batches):
        run(batches[0])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        seen = []
        for rows in batches:
            run(rows)
            torch.cuda.synchronize()
            seen.append(torch.cuda.memory_allocated(dev))
        return base, seen

    def host_ms(prog, rows, b, answer, reps=5):
        """Median host ms to pack, upload and copy back one panel."""
        parts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            panel = pack(rows, b)
            t1 = time.perf_counter()
            dpanel = upload(panel, dev)
            t2 = time.perf_counter()
            res = prog(dpanel)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            answer(res)
            t4 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t4 - t3) * 1e3))
        return [statistics.median(p[i] for p in parts) for i in range(3)]

    def graph_launches(what, prog, want):
        """The union, step and adjoint kernel nodes of ``prog``'s recorded
        graph, read from the graph, must equal what each replay adds to
        the launch counters and ``want``."""
        nodes = graph_kernel_nodes(prog.graph)
        require(nodes == prog.launches_per_replay == want,
                f"{what}: kernel nodes {nodes}, counted per replay "
                f"{prog.launches_per_replay}, want {want}")

    def panel_syncs(serve_panel):
        """Median synchronising operations of three panels, after one."""
        serve_panel()
        torch.cuda.synchronize()
        return statistics.median(synchronising_ops_once(serve_panel) for _ in range(3))

    # ---- (1) programs per bucket --------------------------------------------
    rng = np.random.default_rng(10)
    lines, fused128 = [], None
    for b in SERVE_BUCKETS:
        rows = pool[rng.integers(0, len(pool), b)]
        panel = upload(pack(rows, b), dev)
        prog = filt.panel_program(backend="bsr", donate=True)
        require(isinstance(prog, CudaGraphProgram), f"bucket {b}: no CUDA graph program")
        first, launched = count(lambda: prog(panel).clone())
        expect_launches(f"bucket {b}: first call (warm-up + replay)", launched, (2, 0, 0))
        again, launched = count(lambda: prog(panel).clone())
        expect_launches(f"bucket {b}: a replay", launched, (1, 0, 0))
        graph_launches(f"bucket {b} program", prog, (1, 0, 0))
        eager = filt.apply(panel, backend="bsr")
        fresh = upload(pack(pool[rng.integers(0, len(pool), b)], b), dev)
        d_eager = max(err(first, eager), err(again, eager),
                      err(count(lambda: prog(fresh).clone())[0], filt.apply(fresh, backend="bsr")))
        require(d_eager <= REPLAY_TOL, f"bucket {b}: replay vs eager {d_eager:.3e}")
        d_solo = max(err(first[:, :, i], filt.apply(panel[:, i], backend="bsr"))
                     for i in range(b))
        require(d_solo <= SOLO_TOL, f"bucket {b}: column vs solo bsr apply {d_solo:.3e}")
        d_dense = err(first, filt.apply(panel, backend="dense"))
        require(d_dense <= AGREE_TOL, f"bucket {b}: replay vs dense {d_dense:.3e}")
        batches = [pool[rng.integers(0, len(pool), b)] for _ in range(5)]
        base, seen = memory_flat(
            lambda r: count(lambda: host_copy(prog(upload(pack(r, b), dev)))), batches)
        require(seen == [base] * 5, f"bucket {b}: memory_allocated {base} -> {seen}")
        require(prog.captures == 1, f"bucket {b}: {prog.captures} captures")
        eager_ms = median_ms(lambda: filt.apply(panel, backend="bsr"))
        replay_ms = median_ms(lambda: prog(panel))
        pk, up, cb = host_ms(prog, rows, b, host_copy)
        syncs = panel_syncs(lambda: host_copy(prog(upload(pack(rows, b), dev))))
        out[f"apply_{b}"] = {"eager_ms": eager_ms, "replay_ms": replay_ms, "pack_ms": pk,
                             "upload_ms": up, "copy_ms": cb, "syncs": syncs}
        lines.append(f"b={b}: eager {eager_ms:.4f} ms replay {replay_ms:.4f} ms, host pack "
                     f"{pk:.3f} upload {up:.3f} copy back {cb:.3f} ms, syncs {syncs}; "
                     f"|replay-eager| {d_eager:.1e} |col-solo| {d_solo:.1e} |dense| {d_dense:.1e}, "
                     f"captures {prog.captures}, memory flat at {base} B")
        if b == SERVE_BUCKETS[-1]:
            fused128 = (panel, first)
        # The union kernel inside a recorded graph at this lane's operands
        # (the permuted panel), against its plain version.
        if b in (SERVE_BUCKETS[0], SERVE_BUCKETS[-1]):
            fp = panel[state.perm].contiguous()
            kprog = CudaGraphProgram(lambda f: cheb_bsr.cheb_union_cuda(
                bell.blocks, bell.cols, f, coeffs=filt.coeffs, lmax=lmax), dev)
            got = kprog(fp)
            want = tref.cheb_union_ref(bell.blocks, bell.cols, fp, filt.coeffs, lmax)
            e = (got - want).abs()
            require(bool((e <= UNION_TOL + UNION_TOL * want.abs()).all()),
                    f"cheb_union in a graph, F={b}: max err {float(e.max()):.3e}")
            out["union_err"] = max(out["union_err"], float(e.max()))
            say(f"[serve] cheb_union replayed from a CUDA graph at F={b} max|kernel-plain| "
                f"{float(e.max()):.3e} (tol {UNION_TOL:g}) ok")
    say("[serve] apply programs (bsr, N=%d, eta=%d, M=%d): " % (n, filt.eta, filt.order)
        + "; ".join(lines))

    # The stepwise route: M step launches per replay, against the fused program.
    panel, fused_out = fused128
    b = panel.shape[1]
    sprog = filt.panel_program(backend="bsr", donate=True, fuse=False)
    step_out, launched = count(lambda: sprog(panel).clone())
    expect_launches("stepwise program first call", launched, (0, 2 * filt.order, 0))
    step_out, launched = count(lambda: sprog(panel).clone())
    expect_launches("stepwise program replay", launched, (0, filt.order, 0))
    require(sprog.captures == 1, f"stepwise program: {sprog.captures} captures")
    graph_launches("stepwise program", sprog, (0, filt.order, 0))
    d_sf = err(step_out, fused_out)
    require(d_sf <= SOLO_TOL, f"stepwise vs fused program {d_sf:.3e}")
    t1 = panel[state.perm].contiguous()
    t2 = fused_out[1][state.perm].contiguous()
    kprog = CudaGraphProgram(lambda t: cheb_bsr.cheb_step_cuda(
        bell.blocks, bell.cols, t, t2, alpha=lmax / 2.0), dev)
    got = kprog(t1)
    want = tref.cheb_step_ref(bell.blocks, bell.cols, t1, t2, lmax / 2.0)
    e = (got - want).abs()
    require(bool((e <= F32_STEP_TOL + F32_STEP_TOL * want.abs()).all()),
            f"cheb_step in a graph: max err {float(e.max()):.3e}")
    out["step_err"] = float(e.max())
    step_eager = median_ms(lambda: filt.apply(panel, backend="bsr", fuse=False))
    step_replay = median_ms(lambda: sprog(panel))
    out["stepwise_128"] = {"eager_ms": step_eager, "replay_ms": step_replay}
    say(f"[serve] stepwise program b={b}: launches step {filt.order} per replay, "
        f"|stepwise-fused| {d_sf:.2e} (tol {SOLO_TOL:g}); eager {step_eager:.4f} ms replay "
        f"{step_replay:.4f} ms; cheb_step replayed from a CUDA graph max|kernel-plain| "
        f"{float(e.max()):.3e} (tol {F32_STEP_TOL:g}) ok")

    # FISTA-8 solve programs, built and first run by the async engine's
    # solve lane (one full panel per bucket).
    solver = lasso_panel_solver(filt, mu=1.0, n_iters=SERVE_ITERS)
    eng = AsyncGraphFilterEngine(filt, backend="bsr", solver=solver, device=dev,
                                 config=SchedulerConfig(max_panel=SERVE_BUCKETS[-1],
                                                        min_bucket=SERVE_BUCKETS[0]))
    lines = []
    for b in (SERVE_BUCKETS[0], SERVE_BUCKETS[-1]):
        rows = pool[rng.integers(0, len(pool), b)]
        panel = upload(pack(rows, b), dev)

        def first_panel(rows=rows):
            tickets = [eng.submit_solve(r, now=0.0) for r in rows]
            eng.drain(now=0.0)
            return tickets

        tickets, launched = count(first_panel)
        want_l = (2 * (SERVE_ITERS + 1), 0, 2 * (SERVE_ITERS + 1))
        expect_launches(f"solve bucket {b}: first panel", launched, want_l)
        sp = eng.cache.programs()[("solve", "bsr", n, b)]
        prog = sp.program
        require(isinstance(prog, CudaGraphProgram) and prog.captures == 1,
                f"solve bucket {b}: not recorded once")
        x0 = torch.stack([tk.result.x for tk in tickets], dim=1)
        (x1, a1, h1), launched = count(lambda: tuple(t.clone() for t in prog(panel)))
        expect_launches(f"solve bucket {b}: replay", launched,
                        (SERVE_ITERS + 1, 0, SERVE_ITERS + 1))
        require(prog.captures == 1, f"solve bucket {b}: {prog.captures} captures")
        graph_launches(f"solve bucket {b} program", prog,
                       (SERVE_ITERS + 1, 0, SERVE_ITERS + 1))
        xe, ae, he = prog.fn(panel)
        d_eager = max(err(x0, xe.cpu()), err(x1, xe), err(a1, ae))
        require(d_eager <= SOLO_TOL, f"solve bucket {b}: replay vs eager {d_eager:.3e}")
        solo = fista(LassoProblem(filt=filt, y=panel, mu=1.0), n_iters=SERVE_ITERS, backend="bsr")
        d_solo = err(x1, solo.x)
        require(d_solo <= SERVE_SOLVE_TOL, f"solve bucket {b}: vs fista {d_solo:.3e}")

        def answer(res, k=b):
            return solve_answers(res, k)

        batches = [pool[rng.integers(0, len(pool), b)] for _ in range(5)]
        base, seen = memory_flat(
            lambda r: count(lambda: answer(sp(upload(pack(r, b), dev)))), batches)
        require(seen == [base] * 5, f"solve bucket {b}: memory_allocated {base} -> {seen}")
        eager_ms = median_ms(lambda: prog.fn(panel), reps=5, warmup=1)
        replay_ms = median_ms(lambda: prog(panel), reps=5, warmup=1)
        pk, up, cb = host_ms(sp, rows, b, answer, reps=3)
        syncs = panel_syncs(lambda: answer(sp(upload(pack(rows, b), dev))))
        out[f"solve_{b}"] = {"eager_ms": eager_ms, "replay_ms": replay_ms, "pack_ms": pk,
                             "upload_ms": up, "copy_ms": cb, "syncs": syncs}
        lines.append(f"b={b}: eager {eager_ms:.3f} ms replay {replay_ms:.3f} ms, host pack "
                     f"{pk:.3f} upload {up:.3f} copy back {cb:.3f} ms, syncs {syncs}; "
                     f"|replay-eager| {d_eager:.1e} |x-fista| {d_solo:.1e}, union and adjoint "
                     f"launches {SERVE_ITERS + 1} each per replay, memory flat at {base} B")
    say(f"[serve] FISTA-{SERVE_ITERS} solve programs: " + "; ".join(lines))

    out["programs_s"] = time.perf_counter() - t_phase

    # ---- (2) the sync engine on each lane -------------------------------------
    t_sync = time.perf_counter()
    reqs = np.random.default_rng(11).normal(size=(SERVE_REQUESTS, n)).astype(np.float32)
    width = SERVE_BUCKETS[-1]

    def feed(submit, flush, items):
        got = []
        for item in items:
            res = submit(*item)
            if res:
                got.extend(res)
        tail = flush()
        return got + (tail or [])

    sync = GraphFilterEngine(filt, backend="bsr", panel_width=width, device=dev,
                             solver=lasso_panel_solver(filt, mu=1.0, n_iters=SERVE_ITERS))
    panels = -(-SERVE_REQUESTS // width)
    applies, launched = count(lambda: feed(sync.submit, sync.flush, [(r,) for r in reqs]))
    expect_launches("sync applies", launched, (panels, 0, 0))
    d_apply = max(err(a, filt.apply(torch.as_tensor(r).to(dev), backend="bsr").cpu())
                  for a, r in zip(applies, reqs))
    require(len(applies) == SERVE_REQUESTS and d_apply <= SOLO_TOL,
            f"sync applies vs solo {d_apply:.3e}")
    solves, launched = count(
        lambda: feed(sync.submit_solve, sync.flush_solves, [(r,) for r in reqs]))
    expect_launches("sync solves", launched,
                    (panels * (SERVE_ITERS + 1), 0, panels * (SERVE_ITERS + 1)))
    d_solve = 0.0
    for res, r in zip(solves, reqs):
        solo = fista(LassoProblem(filt=filt, y=torch.as_tensor(r).to(dev), mu=1.0),
                     n_iters=SERVE_ITERS, backend="bsr")
        d_solve = max(d_solve, err(res.x, solo.x.cpu()))
    require(len(solves) == SERVE_REQUESTS and d_solve <= SERVE_SOLVE_TOL,
            f"sync solves vs solo fista {d_solve:.3e}")
    # Frames over 16 streams; each stream's frames come in equal pairs, so
    # every second frame of a stream is served from its cache.
    frames = [(i % SERVE_FRAME_STREAMS,
               pool[(i % SERVE_FRAME_STREAMS + (i // SERVE_FRAME_STREAMS) // 2) % len(pool)])
              for i in range(SERVE_REQUESTS)]
    results, launched = count(lambda: feed(sync.submit_frame, sync.flush_frames, frames))
    filtered = sum(r.mode != "cached" for r in results)
    expect_launches(f"sync frames ({filtered} filtered)", launched, (filtered, 0))
    require(0 < filtered < SERVE_REQUESTS, f"sync frames: {filtered} filtered")
    solo_lanes = {}
    d_frame = 0.0
    for (sid, fr), res in zip(frames, results):
        if sid not in solo_lanes:
            solo_lanes[sid] = StreamingFilter(filt, backend="bsr", device=dev)
        want = solo_lanes[sid].push(fr)
        require(want.mode == res.mode, f"frame mode {res.mode}, standalone {want.mode}")
        d_frame = max(d_frame, err(res.out, want.out))
    require(d_frame <= SOLO_TOL, f"sync frames vs standalone stream {d_frame:.3e}")
    say(f"[serve] sync engine panel_width={width}, {SERVE_REQUESTS} requests per lane: applies "
        f"max|engine-solo bsr| {d_apply:.2e}, union launches {panels} (1 per panel); FISTA-"
        f"{SERVE_ITERS} solves max|x-solo fista| {d_solve:.2e} (tol {SERVE_SOLVE_TOL:g}), union "
        f"launches {panels * (SERVE_ITERS + 1)} (its + 1 per panel); frames over "
        f"{SERVE_FRAME_STREAMS} streams max|engine-standalone| {d_frame:.2e}, {filtered} "
        f"filtered (1 launch each), {SERVE_REQUESTS - filtered} cached (0)")

    out["sync_s"] = time.perf_counter() - t_sync

    # ---- (3) the async engine on the seeded trace -----------------------------
    t_async = time.perf_counter()
    config = SchedulerConfig(max_panel=width, min_bucket=SERVE_BUCKETS[0],
                             latency_budget_s=SERVE_BUDGET_S)

    def make_async():
        return AsyncGraphFilterEngine(filt, backend="bsr", config=config, device=dev,
                                      solver=lasso_panel_solver(filt, mu=1.0, n_iters=SERVE_ITERS))

    def lane_launches(rep):
        return rep["applies"] + rep["solves"] * (SERVE_ITERS + 1) + rep["frames_filtered"]

    reports = {}
    for kind, burst in (("paced", False), ("burst", True)):
        trace = make_trace(SERVE_STREAMS, SERVE_SECONDS, SERVE_RATE, seed=0, burst=burst)
        eng = make_async()
        warm, launched = count(lambda: drive_async(eng, trace, pool, SERVE_FRAME_STREAMS))
        # Each program's graph holds its lane's launches per panel, and a
        # new program's first call adds its eager warm-up run.
        for key, prog in eng.cache.programs().items():
            want_l = (1, 0, 0) if key[0] == "apply" else (SERVE_ITERS + 1, 0, SERVE_ITERS + 1)
            graph_launches(f"{kind} {key}", getattr(prog, "program", prog), want_l)
        warm_ups = sum(1 if key[0] == "apply" else SERVE_ITERS + 1 for key in eng.cache.programs())
        solve_warm_ups = sum(SERVE_ITERS + 1 for key in eng.cache.programs() if key[0] == "solve")
        expect_launches(f"{kind} warm replay", launched,
                        (lane_launches(warm) + warm_ups, 0,
                         warm["solves"] * (SERVE_ITERS + 1) + solve_warm_ups))
        rep, launched = count(lambda: drive_async(eng, trace, pool, SERVE_FRAME_STREAMS))
        require(rep["served"] == rep["requests"] and rep["rejected"] == 0,
                f"{kind}: served {rep['served']} of {rep['requests']}, rejected {rep['rejected']}")
        require(rep["recompiles"] == 0 and rep["captures"] == 0,
                f"{kind} measured replay: {rep['recompiles']} recompiles, "
                f"{rep['captures']} captures")
        expect_launches(f"{kind} measured replay", launched,
                        (lane_launches(rep), 0, rep["solves"] * (SERVE_ITERS + 1)))
        box = {}

        def profiled():
            t0 = time.perf_counter()
            box["rep"] = drive_async(eng, trace, pool, SERVE_FRAME_STREAMS)
            torch.cuda.synchronize()
            box["wall_ms"] = (time.perf_counter() - t0) * 1e3

        (busy_ms, traced), profiled_launches = count(lambda: kernel_profile_once(profiled))
        rep["idle"] = max(0.0, 1 - busy_ms / box["wall_ms"])
        rep["kernel_ms"], rep["wall_ms"] = busy_ms, box["wall_ms"]
        rep["warm_recompiles"] = warm["recompiles"]
        rep["union"] = launched[0]
        reports[kind] = rep
        capacity = f"capacity {rep['served'] / rep['busy_s']:.0f} req/s (busy {rep['busy_s']:.3f} s)"
        if burst:
            # The sync engine at the same width on the same burst, warm.
            sync_eng = GraphFilterEngine(
                filt, backend="bsr", panel_width=width, device=dev,
                solver=lasso_panel_solver(filt, mu=1.0, n_iters=SERVE_ITERS))
            count(lambda: drive_sync(sync_eng, trace, pool, SERVE_FRAME_STREAMS))
            srep, _ = count(lambda: drive_sync(sync_eng, trace, pool, SERVE_FRAME_STREAMS))
            rep["sync"] = srep
            capacity += (f", sync engine width {width} {srep['served'] / srep['busy_s']:.0f} req/s "
                         f"(busy {srep['busy_s']:.3f} s, latency {pct_ms(srep['lat'])})")
        say(f"[serve] async {kind} trace ({rep['requests']} requests, {SERVE_STREAMS} streams, "
            f"seed 0{'' if burst else f', {SERVE_RATE:g}/s over {SERVE_SECONDS:g} s'}): served "
            f"{rep['served']}, rejected {rep['rejected']}; warm replay recompiles "
            f"{warm['recompiles']} (= captures {warm['captures']}), measured replay recompiles "
            f"{rep['recompiles']} captures {rep['captures']}; panels apply {rep['applies']} "
            f"solve {rep['solves']}, frames {rep['frames_served']} ({rep['frames_filtered']} "
            f"filtered); union launches {launched[0]} = sum over panels, each program's graph "
            f"holding its lane's kernel nodes (a profiled replay traced {traced[0]} of its "
            f"{profiled_launches[0]}); latency apply "
            f"{pct_ms(rep['lat']['apply'])}, solve {pct_ms(rep['lat']['solve'])}, frame "
            f"{pct_ms(rep['lat']['frame'])}; {capacity}; pad_waste {rep['pad_waste']:.3f}, streams_evicted "
            f"{rep['streams_evicted']}; device idle share over a replay {rep['idle']:.0%} "
            f"(kernels {busy_ms:.1f} of {box['wall_ms']:.1f} ms)")
    out["reports"] = reports
    out["async_s"] = time.perf_counter() - t_async
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[serve] phase 10 took {out['seconds']:.1f} s: programs {out['programs_s']:.1f}, sync "
        f"engine {out['sync_s']:.1f}, async engine {out['async_s']:.1f}")
    return out


class _ToyTrainer:
    """A trainer with nothing of a model: AdamW steps on a card tree toward
    a fixed target, a checkpoint every ``every`` steps, and a shared
    failure injector (a lost node stays lost across restarts)."""

    def __init__(self, mgr, start_step, injector, dev, every=5):
        import torch

        from repro_torch import checkpoint, optim

        self.mgr, self.injector, self.every = mgr, injector, every
        self.cfg = optim.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=40)
        gen = torch.Generator(device=dev).manual_seed(21)
        self.target = torch.randn(64, 32, generator=gen, device=dev)
        params = {"w": torch.zeros(64, 32, device=dev), "b": torch.zeros(32, device=dev)}
        state = {"params": params, "opt": optim.init_opt_state(params, self.cfg)}
        if start_step:
            state = checkpoint.restore(mgr.dir, start_step, state, device=dev)
        self.params, self.opt = state["params"], state["opt"]

    def run(self, n_steps, start_step=0):
        from repro_torch import optim

        step = start_step
        while step < n_steps:
            self.injector(step)
            grads = {"w": self.params["w"] - self.target, "b": self.params["b"] - 1.0}
            self.params, self.opt, _ = optim.adamw_update(self.params, grads, self.opt, self.cfg)
            step += 1
            if step % self.every == 0 or step == n_steps:
                self.mgr.save_async(step, {"params": self.params, "opt": self.opt})
        self.mgr.wait()
        return {"final_step": step, "opt_step": int(self.opt["step"])}


def gossip_phase(dev) -> dict:
    """Phase 11: Chebyshev gossip consensus on ``StackedMesh(8)`` and the
    model-free training substrate (buckets, AdamW, fault runtime,
    checkpoints) on the card. No bsr kernel runs here (the caller checks)."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch import checkpoint, gossip_consensus, optim, runtime
    from repro_torch.core import gossip
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    p, m = GOSSIP_RANKS, GOSSIP_ORDER
    out = {}

    # -- exact, at the example's shape ---------------------------------------
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ex = gossip_consensus.main(device=dev)
    for line in log.getvalue().splitlines():
        if line.strip():
            say(f"[gossip] example | {line}")
    for order, (rel, bnd) in sorted(ex["orders"].items()):
        require(rel <= 1.05 * bnd, f"gossip M={order}: err/init {rel:.3e} > 1.05 x {bnd:.3e}")
    n_ex = ex["n_params"]
    total = ex["bucketed"]["bucketed f32"]["words"] * p
    require(total == gossip.gossip_message_words(m, p, n_ex) == 399360,
            f"ring words {total} at M={m}, P={p} (want 399360)")
    bf16 = ex["bucketed"]["bucketed bf16"]
    require(bf16["rel_err"] <= gossip.payload_roundoff_bound(m),
            f"bf16 payload error {bf16['rel_err']:.3e} > {gossip.payload_roundoff_bound(m)}")
    mesh = StackedMesh(p, dev)
    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn(p, 64, 32, generator=gen).to(dev),
             "b": torch.randn(p, 32, generator=gen).to(dev)}
    serial = gossip.chebyshev_gossip_mean(grads, mesh, order=m)
    for k_b in (2, 4):
        packed = gossip_consensus.sync_bucketed(grads, mesh, k_b, m)
        require(all(torch.equal(serial[k], packed[k]) for k in grads),
                f"{k_b}-bucket f32 gossip differs from per-leaf gossip")
    injected = {}
    for r in (0, 4):
        inj = runtime.StragglerInjector(alpha_ms=0.0)
        gossip.chebyshev_gossip_mean(grads, mesh, order=m, truncate=r, round_delay=inj.gossip_round)
        injected[r] = inj.rounds_injected
        require(inj.rounds_injected == p * (m - r),
                f"rounds_injected {inj.rounds_injected} at truncate={r} (want {p * (m - r)})")
    say(f"[gossip] exact, P={p} w 64x32 b 32: err/init within 1.05x the bound at M="
        + ",".join(str(o) for o in sorted(ex["orders"])) + f"; ring words at M={m} {total} "
        f"(analytic {gossip.gossip_message_words(m, p, n_ex)}), per rank f32 "
        f"{ex['bucketed']['bucketed f32']['words']} bf16 {bf16['words']}; per-leaf == 2- and "
        f"4-bucket bit for bit; bf16 err/init {bf16['rel_err']:.3e} (bound "
        f"{gossip.payload_roundoff_bound(m):.4f}); rounds_injected r=0 {injected[0]}, r=4 "
        f"{injected[4]}")

    # -- timed, at a size a data-parallel user syncs ------------------------
    side, order = GOSSIP_SIDE, gossip.required_order(p, GOSSIP_EPS)
    g_big = torch.Generator(device=dev).manual_seed(11)
    big = {}
    for i in range(GOSSIP_LEAVES):
        big[f"w{i}"] = torch.randn(p, side, side, generator=g_big, device=dev)
        big[f"b{i}"] = torch.randn(p, side, generator=g_big, device=dev)
    n_rank = sum(v[0].numel() for v in big.values())
    mean = {k: v.mean(dim=0) for k, v in big.items()}

    def disagreement(tree):
        return math.sqrt(sum(float(((tree[k] - mean[k][None]) ** 2).sum()) for k in big))

    init = disagreement(big)
    lam1, lmax = gossip.ring_spectrum_bounds(p)
    contraction = gossip.consensus_contraction(order, lam1, lmax)
    # A round reads t_{k-1}, t_{k-2} and the sum and writes t_k and the sum,
    # each P x n f32 once (the exchange need not touch memory on one card).
    round_bytes = 5 * p * n_rank * 4
    round_bound_ms = round_bytes / HBM_BYTES_PER_S * 1e3
    out["timed"] = []
    for n_buckets in GOSSIP_BUCKETS:
        for payload in (None, "bfloat16"):
            label = f"K={n_buckets} {payload or 'float32'}"

            def fn(n_buckets=n_buckets, payload=payload):
                return gossip_consensus.sync_bucketed(big, mesh, n_buckets, order, payload)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            res = {}
            words = gossip.measured_ppermute_words(mesh, lambda: res.update(fn()))
            analytic = gossip.gossip_message_words(order, p, n_rank) // p
            require(words == (analytic if payload is None else analytic // 2),
                    f"gossip {label}: words per rank {words}, analytic {analytic}")
            rel = disagreement(res) / init
            limit = contraction * 1.05 if payload is None else gossip.payload_roundoff_bound(order)
            require(rel <= limit, f"gossip {label}: err/init {rel:.3e} > {limit:.3e}")
            del res
            peak = torch.cuda.max_memory_allocated(dev)
            ms = median_ms(fn, reps=GOSSIP_REPS, warmup=1)
            rec = {"label": label, "ms": ms, "ms_per_round": ms / order, "words": words,
                   "rel_err": rel, "peak_gb": peak / 1e9, "extra_gb": (peak - base) / 1e9}
            out["timed"].append(rec)
            say(f"[gossip] timed P={p} n={n_rank} per rank ({GOSSIP_LEAVES} x {side}^2 + "
                f"{GOSSIP_LEAVES} x {side}) M={order} {label}: {ms:.3f} ms per sync, "
                f"{ms / order:.3f} ms per round (bound {round_bound_ms:.3f}: "
                f"{round_bytes / 1e9:.2f} GB read+written per round at 3.35 TB/s, "
                f"{round_bound_ms / (ms / order):.1%} of it); words per rank {words}; "
                f"err/init {rel:.3e} (bound {limit:.3e}); peak memory_allocated "
                f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the tree)")
    del big, mean

    # -- the substrate on the card ---------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(257, 33, generator=gen, device=dev)
        tree = {"f32": x, "bf16": x.bfloat16(), "fp8": [x.to(torch.float8_e4m3fn),
                                                         x.to(torch.float8_e5m2)],
                "int32": torch.arange(1000, dtype=torch.int32, device=dev), "step": torch.tensor(
                    7, dtype=torch.int32, device=dev)}
        checkpoint.save(tmp, 7, tree)
        back = checkpoint.restore(tmp, 7, tree, device=dev)
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            require(b.device == a.device and b.dtype == a.dtype and b.shape == a.shape
                    and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)),
                    f"checkpoint round trip of a {a.dtype} leaf")
        cfg = optim.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20)
        gcpu = torch.Generator().manual_seed(4)
        params = {"w": torch.randn(512, 256, generator=gcpu), "b": torch.randn(256, generator=gcpu)}
        gseq = [tree_map(lambda v: torch.randn(v.shape, generator=gcpu), params) for _ in range(5)]
        state = {"cpu": (params, optim.init_opt_state(params, cfg))}
        dparams = tree_map(lambda v: v.to(dev), params)
        state["card"] = (dparams, optim.init_opt_state(dparams, cfg))
        for g_step in gseq:
            for where, (pp, st) in list(state.items()):
                g = g_step if where == "cpu" else tree_map(lambda v: v.to(dev), g_step)
                pp, st, _ = optim.adamw_update(pp, g, st, cfg)
                state[where] = (pp, st)
        adam_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(state["card"]), tree_leaves(state["cpu"])))
        require(adam_err <= ADAMW_TOL, f"AdamW card vs CPU after 5 steps: {adam_err:.3e}")
        mgr = checkpoint.CheckpointManager(os.path.join(tmp, "train"), keep=2)
        injector = runtime.FailureInjector([12, 23])

        def latest():
            mgr.wait()
            return checkpoint.latest_step(mgr.dir)

        rr = runtime.run_with_restarts(lambda s: _ToyTrainer(mgr, s, injector, dev), 30, latest)
        require(rr["final_step"] == 30 and rr["opt_step"] == 30 and rr["restarts"] == 2,
                f"run_with_restarts: {rr}")
        kept = sorted(int(q.name.split("_")[1]) for q in mgr.dir.glob("step_*"))
        require(kept == [25, 30], f"checkpoints kept {kept}")
    say(f"[gossip] substrate on the card: checkpoint round trip (f32, bf16, fp8 e4m3fn and "
        f"e5m2, int32) bit for bit; 5 AdamW steps card vs CPU max |diff| {adam_err:.3e} "
        f"(tol {ADAMW_TOL:g}); run_with_restarts with failures at steps 12 and 23: final step "
        f"{rr['final_step']}, restarts {rr['restarts']}, checkpoints kept {kept}")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[gossip] phase 11 took {out['seconds']:.1f} s")
    return out


def lm_work(cfg, batch: int, prompt: int, s_max: int, param_bytes: int, n_params: int) -> dict:
    """Bytes and operations of Gemma-2-style serving (every layer attention
    with a gated dense FFN): one naive-attention prefill of ``batch`` x
    ``prompt`` tokens (the projections and FFNs, the full S x S scores and
    their weighted sum, the second k/v pass that fills the cache, the last
    position's unembedding) and one decode step (every weight read once,
    the whole ``s_max`` cache the naive decode reads, one token's k/v
    written)."""
    t = batch * prompt
    hq, hkv, d = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_, cfg.d_model
    n_layers, elem = cfg.n_layers, 2 if cfg.activation_dtype == "bfloat16" else 4
    proj = 2 * t * d * (2 * hq + 2 * hkv)
    ffn = 2 * t * d * cfg.d_ff * 3
    attn = 4 * batch * cfg.n_heads * prompt * prompt * cfg.head_dim_
    kv_again = 2 * t * d * 2 * hkv
    cache_bytes = n_layers * 2 * batch * s_max * hkv * elem
    return {
        "prefill_flops": n_layers * (proj + ffn + attn + kv_again) + 2 * batch * d * cfg.vocab_size,
        "prefill_parts": (n_layers * (proj + ffn), n_layers * attn, n_layers * kv_again),
        "prefill_bytes": param_bytes + n_layers * 2 * t * hkv * elem,
        "decode_bytes": param_bytes + cache_bytes + n_layers * 2 * batch * hkv * elem,
        "decode_flops": 2 * batch * n_params + 4 * batch * cfg.n_heads * s_max * cfg.head_dim_
        * n_layers,
        "cache_bytes": cache_bytes,
    }


def lm_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """``bound`` at the bf16 tensor-core peak (the LM's matmuls are bf16)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def lm_phase(dev) -> dict:
    """Phase 12: LM serving on the card (see the module docstring). Plain
    torch: no bsr kernel runs here (the caller checks)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import make_decode_step, make_prefill
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    par = launch_serve.PAR
    out = {}

    # -- (a) Gemma-2 2B, full width and depth, bf16, through the launcher ----
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    cfg, params = launch_serve.build(LM_ARCH, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    require((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.param_dtype, cfg.window_size)
            == (26, 2304, 256000, "bfloat16", 4096), f"not Gemma-2 2B's published config: {cfg}")
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    require(all(t.device == dev and t.dtype == torch.bfloat16 for t in leaves),
            "Gemma-2 2B params are not all bf16 on the card")
    runs = [launch_serve.serve(cfg, params, batch=LM_BATCH, prompt_len=LM_PROMPT, tokens=LM_NEW,
                               device=dev) for _ in range(2)]
    ids = [t for row in runs[0]["tokens"] for t in row]
    require(runs[0]["tokens"] == runs[1]["tokens"], "greedy ids differ between two runs")
    require(len(ids) == LM_BATCH * LM_NEW and all(0 <= t < cfg.vocab_size for t in ids),
            "greedy ids out of shape or vocabulary")

    s_max = LM_PROMPT + LM_NEW + 8
    require(s_max - LM_PROMPT >= 29, "the timed steps (20 + 1 + 8) outrun the cache")
    prefill = make_prefill(cfg, par, s_max=s_max)
    step = make_decode_step(cfg, par)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    with torch.inference_mode():
        timed = []
        for _ in range(3):
            start, stop = events()
            start.record()
            logits, cache = prefill(params, tokens)
            stop.record()
            timed.append((start, stop))
        torch.cuda.synchronize()
        prefill_ms = statistics.median(a.elapsed_time(b) for a, b in timed)
        require(logits.shape == (LM_BATCH, 1, cfg.vocab_size), f"prefill logits {logits.shape}")
        finite = torch.isfinite(logits).all()
        token = logits[:, -1].argmax(-1)[:, None]
        timed = []
        for _ in range(20):
            start, stop = events()
            start.record()
            logits, cache = step(params, token, cache)
            stop.record()
            timed.append((start, stop))
            finite &= torch.isfinite(logits).all()
            token = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_times = [a.elapsed_time(b) for a, b in timed[4:]]
        decode_ms = statistics.median(step_times)

        def one_step():
            nonlocal logits, cache, token, finite
            logits, cache = step(params, token, cache)
            finite &= torch.isfinite(logits).all()
            token = logits[:, -1].argmax(-1)[:, None]

        syncs = synchronising_ops_once(one_step)
        window = events()

        def eight_steps():
            window[0].record()
            for _ in range(8):
                one_step()
            window[1].record()

        decode_evs = profiled_kernels(eight_steps)
        wall_ms = window[0].elapsed_time(window[1])
        kernel_ms, decode_gemm_ms, decode_top = kernel_split(decode_evs, per=8)
        kernel_ms *= 8
        prefill_evs = profiled_kernels(lambda: prefill(params, tokens))
        prefill_kernel_ms, prefill_gemm_ms, prefill_top = kernel_split(prefill_evs)
        require(int(cache["pos"]) == LM_PROMPT + 29, f"cache pos {int(cache['pos'])}")
        require(bool(finite), "a non-finite logit in the full-width prefill or decode")
    peak = torch.cuda.max_memory_allocated(dev)
    work = lm_work(cfg, LM_BATCH, LM_PROMPT, s_max, param_bytes, n_params)
    pb, pb_by = lm_bound(work["prefill_bytes"], work["prefill_flops"])
    db, db_by = lm_bound(work["decode_bytes"], work["decode_flops"])
    busy = kernel_ms / wall_ms
    out.update(n_params=n_params, param_bytes=param_bytes, init_s=init_s, peak_gb=peak / 1e9,
               extra_gb=(peak - base) / 1e9, prefill_ms=prefill_ms, prefill_bound_ms=pb,
               prefill_bound_by=pb_by, decode_ms=decode_ms, decode_bound_ms=db,
               decode_bound_by=db_by, decode_steps_ms=step_times,
               tokens_per_s=runs[1]["tokens_per_s"], serve_wall_s=[r["wall_s"] for r in runs],
               decode_tokens_per_s=LM_BATCH / decode_ms * 1e3, decode_syncs=syncs,
               decode_kernel_ms=kernel_ms / 8, decode_wall_ms=wall_ms / 8, decode_idle=1 - busy)
    parts = work["prefill_parts"]
    say(f"[lm] (a) {cfg.name}: {n_params / 1e9:.4f} B params, {param_bytes / 1e9:.4f} GB bf16 "
        f"(init on the card {init_s:.2f} s); batch {LM_BATCH} x prompt {LM_PROMPT} + {LM_NEW} "
        f"new tokens, s_max {s_max}, attn naive; greedy ids equal over 2 launcher runs "
        f"(sample {runs[0]['sample']}); every prefill and decode logit finite")
    say(f"[lm] (a) launcher wall {runs[0]['wall_s']:.3f} s then {runs[1]['wall_s']:.3f} s "
        f"-> {runs[1]['tokens_per_s']:.1f} tokens/s end to end (prefill included); peak "
        f"memory_allocated {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the phase's "
        f"start); KV cache {work['cache_bytes'] / 1e9:.3f} GB")
    say(f"[lm] (a) prefill {prefill_ms:.2f} ms (median of 3), bound {pb:.2f} ms by {pb_by}: "
        f"{work['prefill_flops'] / 1e12:.2f} TFLOP (projections+FFN {parts[0] / 1e12:.2f}, "
        f"naive S^2 attention {parts[1] / 1e12:.2f}, cache k/v pass {parts[2] / 1e12:.2f}) at "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 -> {pb / prefill_ms:.1%} of the bound")
    say(f"[lm] (a) decode step {decode_ms:.3f} ms (median of 16; min {min(step_times):.3f} max "
        f"{max(step_times):.3f}), bound {db:.3f} ms by {db_by}: "
        f"{work['decode_bytes'] / 1e9:.3f} GB (weights {param_bytes / 1e9:.3f} + s_max cache "
        f"{work['cache_bytes'] / 1e9:.3f}) at 3.35 TB/s -> {db / decode_ms:.1%} of the bound; "
        f"{LM_BATCH / decode_ms * 1e3:.1f} tokens/s in decode; synchronising operations per "
        f"step {syncs}")
    say(f"[lm] (a) decode idle share (torch.profiler, 8 steps): kernel time "
        f"{kernel_ms / 8:.3f} ms per step over wall {wall_ms / 8:.3f} ms -> idle "
        f"{1 - busy:.1%}; matrix multiplies {decode_gemm_ms:.3f} ms per step; top kernels "
        f"per step: {decode_top}")
    say(f"[lm] (a) prefill device time {prefill_kernel_ms:.2f} ms (torch.profiler, one call): "
        f"matrix multiplies {prefill_gemm_ms:.2f} ms, the rest {prefill_kernel_ms - prefill_gemm_ms:.2f}"
        f" ms; top kernels: {prefill_top}")
    out.update(decode_gemm_ms=decode_gemm_ms, prefill_kernel_ms=prefill_kernel_ms,
               prefill_gemm_ms=prefill_gemm_ms)
    del params, cache, logits, token, tokens, prefill, step
    torch.cuda.empty_cache()

    # -- (b) full widths at 2 layers, f32, card against CPU --------------------
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the f32 checks")
    cfg_b = dataclasses.replace(registry.get(LM_ARCH), n_layers=2, window_size=LM_NUM_WINDOW,
                                param_dtype="float32", activation_dtype="float32")
    p_card, _ = lm.init(torch.Generator(device=dev).manual_seed(1), cfg_b, dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    tok = torch.randint(0, cfg_b.vocab_size, (1, LM_NUM_PROMPT),
                        generator=torch.Generator().manual_seed(1))
    s_max_b = LM_NUM_PROMPT + LM_NUM_STEPS
    step_b = make_decode_step(cfg_b, par)
    t0 = time.perf_counter()
    with torch.inference_mode():
        l_card, c_card = lm.prefill(p_card, tok.to(dev), cfg_b, par, s_max=s_max_b)
        l_cpu, c_cpu = lm.prefill(p_cpu, tok, cfg_b, par, s_max=s_max_b)
        l_naive = l_card.clone()
        errs = [float((l_card.cpu() - l_cpu).abs().max())]
        for _ in range(LM_NUM_STEPS):
            t_cpu = l_cpu[:, -1].argmax(-1)[:, None]
            require(torch.equal(l_card[:, -1].argmax(-1)[:, None].cpu(), t_cpu),
                    "f32 full-width greedy ids differ between card and CPU")
            l_card, c_card = step_b(p_card, t_cpu.to(dev), c_card)
            l_cpu, c_cpu = step_b(p_cpu, t_cpu, c_cpu)
            errs.append(float((l_card.cpu() - l_cpu).abs().max()))
        require(max(errs) <= LM_NUM_TOL, f"f32 full width card vs CPU: {max(errs):.3e}")
        # -- (d) chunked against naive at (b)'s shape ---------------------------
        chunk_err = {}
        for chunk in (1024, 256):
            par_c = ParallelConfig(attn_impl="chunked", attn_chunk=chunk, remat="none")
            l_chunk, _ = lm.prefill(p_card, tok.to(dev), cfg_b, par_c, s_max=s_max_b)
            chunk_err[chunk] = float((l_chunk - l_naive).abs().max())
            require(chunk_err[chunk] <= LM_CHUNK_TOL,
                    f"chunked ({chunk}) vs naive prefill: {chunk_err[chunk]:.3e}")
    out.update(num_err=max(errs), chunk_err=chunk_err)
    say(f"[lm] (b) {cfg_b.name} full widths at 2 layers (local + global), f32, TF32 off, window "
        f"{LM_NUM_WINDOW} (this check only), batch 1 x prompt {LM_NUM_PROMPT}: card vs CPU max "
        f"|dlogit| prefill {errs[0]:.3e}, over {LM_NUM_STEPS} greedy decode steps "
        f"{max(errs[1:]):.3e} (tol {LM_NUM_TOL:g}); greedy ids equal ({time.perf_counter() - t0:.1f} s)")
    say("[lm] (d) chunked vs naive prefill logits at (b)'s shape: " + ", ".join(
        f"chunk {c} {e:.3e}" for c, e in chunk_err.items()) + f" (tol {LM_CHUNK_TOL:g})")
    del p_card, p_cpu, c_card, c_cpu, l_card, l_cpu, l_naive
    torch.cuda.empty_cache()

    # -- (c) every smoke config, f32, card against CPU ---------------------------
    smoke = {}
    for arch in [a for a in registry.ARCH_IDS if a != "sensor_gsp"]:
        cfg_s = registry.get_smoke(arch)
        p_cpu, _ = lm.init(torch.Generator().manual_seed(2), cfg_s, "cpu")
        p_card = tree_map(lambda t: t.to(dev), p_cpu)
        g = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg_s.vocab_size, (2, 16), generator=g)
        extra = None
        if cfg_s.family in ("vlm", "audio"):
            extra = 0.02 * torch.randn(2, 8, cfg_s.d_model, generator=g)
        step_s = make_decode_step(cfg_s, par)
        worst = 0.0
        with torch.inference_mode():
            l_card, c_card = lm.prefill(p_card, toks.to(dev), cfg_s, par, s_max=16 + LM_SMOKE_STEPS,
                                        extra_embeds=None if extra is None else extra.to(dev))
            l_cpu, c_cpu = lm.prefill(p_cpu, toks, cfg_s, par, s_max=16 + LM_SMOKE_STEPS,
                                      extra_embeds=extra)
            for i in range(LM_SMOKE_STEPS + 1):
                diff = (l_card.cpu() - l_cpu).abs()
                worst = max(worst, float(diff.max()))
                require(bool((diff <= LM_SMOKE_TOL + LM_SMOKE_TOL * l_cpu.abs()).all()),
                        f"{arch} smoke card vs CPU logits: {float(diff.max()):.3e}")
                t_cpu = l_cpu[:, -1].argmax(-1)[:, None]
                require(torch.equal(l_card[:, -1].argmax(-1)[:, None].cpu(), t_cpu),
                        f"{arch} smoke greedy ids differ between card and CPU")
                if i < LM_SMOKE_STEPS:
                    l_card, c_card = step_s(p_card, t_cpu.to(dev), c_card)
                    l_cpu, c_cpu = step_s(p_cpu, t_cpu, c_cpu)
        smoke[arch] = worst
    out["smoke_err"] = smoke
    say(f"[lm] (c) smoke configs, f32, prefill + {LM_SMOKE_STEPS} greedy decode steps, card vs "
        f"CPU max |dlogit| (tol {LM_SMOKE_TOL:g} + {LM_SMOKE_TOL:g} x |logit|), greedy ids equal: "
        + ", ".join(f"{a} {e:.2e}" for a, e in smoke.items()))
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[lm] phase 12 took {out['seconds']:.1f} s")
    return out


def train_work(cfg, params, n_seqs: int, seq: int, chunk: int) -> dict:
    """Operations of one training step on ``n_seqs`` sequences of ``seq``
    tokens, from the shapes: every matmul weight (the stacked blocks' and
    the tied unembedding; the embedding lookup is no matmul) at 6 FLOPs
    per weight per token, and attention's two contractions (scores and
    their weighted sum, 4 S_q S_kv d per head per layer forward) over the
    full square the chunked path computes (``S_kv`` padded to whole
    chunks), 3x for forward and backward. ``executed`` adds the remat
    recompute: each group's forward once more (the blocks' weights and the
    attention forward, not the head)."""
    from repro_torch.tree import tree_leaves

    tokens = n_seqs * seq
    block_mm = sum(t.numel() for t in tree_leaves(params["blocks"]) if t.dim() >= 3)
    head = cfg.vocab_size * cfg.d_model
    s_kv = -(-seq // chunk) * chunk
    attn_fwd = 4 * n_seqs * seq * s_kv * cfg.n_heads * cfg.head_dim_ * cfg.n_layers
    model = 6 * (block_mm + head) * tokens + 3 * attn_fwd
    return {"tokens": tokens, "model_flops": model,
            "executed_flops": model + 2 * block_mm * tokens + attn_fwd,
            "matmul_params": block_mm + head, "attn_fwd_flops": attn_fwd}


def _checkpoint_dir(need_bytes: int) -> Path:
    """A directory on local disk (the temp dir) or in ``/dev/shm``,
    whichever has room for ``need_bytes`` (with 10 % to spare)."""
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), "/dev/shm"):
        if os.path.isdir(base) and shutil.disk_usage(base).free > 1.1 * need_bytes:
            return Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base))
    raise RuntimeError(f"no directory holds a {need_bytes / 1e9:.1f} GB checkpoint")


def _grad_errors(got, want, rel: float, abs_tol: float, elem_rel: float = 0.0):
    """Per-leaf max |got - want| of two gradient trees (``got`` moved to
    ``want``'s device) and whether each is within ``abs_tol + rel
    max|want| + elem_rel |want|``; returns ``(worst, all_ok)``."""
    from repro_torch.tree import tree_leaves

    worst, ok = 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().to(b.device).float(), b.detach().float()
        diff = (a - b).abs()
        tol = abs_tol + rel * float(b.abs().max()) + elem_rel * b.abs()
        ok &= bool((diff <= tol).all())
        worst = max(worst, float(diff.max()))
    return worst, ok


def train_phase(dev) -> dict:
    """Phase 13: training on the card (see the module docstring). Plain
    torch: no bsr kernel runs here (the caller checks)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch import train
    from repro_torch.checkpoint import CheckpointManager, latest_step, restore
    from repro_torch.configs import registry
    from repro_torch.core import gossip
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.donation import jit_train_step
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelConfig
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.runtime import FailureInjector, run_with_restarts
    from repro_torch.train_lm import PRESETS, preset_config
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    out = {}

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # -- (a) Gemma-2 2B, full width, through the Trainer ----------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = registry.get(TRAIN_ARCH)
    require((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.param_dtype, cfg.window_size)
            == (26, 2304, 256000, "bfloat16", 4096), f"not Gemma-2 2B's published config: {cfg}")
    par = ParallelConfig(attn_impl="chunked", attn_chunk=TRAIN_CHUNK, remat="block",
                         microbatches=TRAIN_MICRO)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    optc = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    step_fn = jit_train_step(train.make_train_step(cfg, par, optc))
    timing, mem, ptrs = [], [], []

    def timed_step(params, opt, batch):
        start, stop = events()
        start.record()
        result = step_fn(params, opt, batch)
        stop.record()
        timing.append((start, stop))
        mem.append(torch.cuda.memory_allocated(dev))
        ptrs.append([t.data_ptr() for t in tree_leaves(result[0])])
        return result

    class TimedCheckpoints(CheckpointManager):
        save_s = wait_s = 0.0

        def save_async(self, step, tree):
            t0 = time.perf_counter()
            super().save_async(step, tree)
            self.save_s = time.perf_counter() - t0

        def wait(self):
            t0 = time.perf_counter()
            super().wait()
            self.wait_s = time.perf_counter() - t0

    trainers = []

    def make_trainer(start_step):
        require(start_step == 0, f"the full-width run restarted from step {start_step}")
        params, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
        trainers.append(train.Trainer(train_step=timed_step, pipeline=pipe, ckpt=mgr,
                                      params=params, opt_state=init_opt_state(params, optc),
                                      ckpt_every=n_steps + 1))
        return trainers[-1]

    abstract, _ = lm.abstract_init(cfg)
    n_params = sum(t.numel() for t in tree_leaves(abstract))
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(abstract))
    ckpt_bytes = param_bytes + 2 * 4 * n_params
    ckpt_dir = _checkpoint_dir(ckpt_bytes)
    mgr = TimedCheckpoints(ckpt_dir, keep=1)
    try:
        t0 = time.perf_counter()
        result = run_with_restarts(make_trainer, n_steps, latest_step_fn=lambda: latest_step(ckpt_dir))
        run_s = time.perf_counter() - t0
        written = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
        free_after = shutil.disk_usage(ckpt_dir).free
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = result["losses"]
    step_ms = [a.elapsed_time(b) for a, b in timing]
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    require(result["final_step"] == n_steps and result["restarts"] == 0,
            f"full-width run ended at {result['final_step']} after {result['restarts']} restarts")
    require(all(math.isfinite(x) for x in losses), f"non-finite full-width losses {losses}")
    drift = max(mem[2:]) - min(mem[2:])
    require(drift <= TRAIN_MEM_SLACK, f"memory_allocated moved {drift} B over steps 3-{n_steps}")
    require(all(p == ptrs[0] for p in ptrs), "the donated step moved a parameter's storage")
    trainer = trainers[-1]
    work = train_work(cfg, trainer.params, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK)
    bound_ms = work["model_flops"] / BF16_FLOPS_PER_S * 1e3
    bytes_ms = 2 * ckpt_bytes / HBM_BYTES_PER_S * 1e3  # read and write params and moments
    batch = pipe.batch_at(n_steps)
    window = events()

    def one_step():
        window[0].record()
        trainer.params, trainer.opt_state, _ = step_fn(trainer.params, trainer.opt_state, batch)
        window[1].record()

    evs = profiled_kernels(one_step)
    wall_ms = window[0].elapsed_time(window[1])
    kernel_ms, gemm_ms, top = kernel_split(evs)
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves((trainer.params, trainer.opt_state)))
    out.update(n_params=n_params, step_ms=step_ms, step_median_ms=med,
               held_bytes=held, peak_bytes=peak, base_bytes=base_mem,
               tokens_per_s=work["tokens"] / med * 1e3, bound_ms=bound_ms,
               model_flops=work["model_flops"], executed_flops=work["executed_flops"],
               peak_gb=peak / 1e9, mem_drift=drift, ckpt_bytes=written,
               save_async_s=mgr.save_s, wait_s=mgr.wait_s, kernel_ms=kernel_ms,
               gemm_ms=gemm_ms, profiled_wall_ms=wall_ms, idle=1 - kernel_ms / med,
               losses=losses)
    say(f"[train] (a) {cfg.name}: {n_params / 1e9:.4f} B params bf16, AdamW f32 moments; "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens per step in {TRAIN_MICRO} microbatches, chunked "
        f"attention ({TRAIN_CHUNK}), remat block, donated (in-place) step; "
        f"{n_steps} steps through Trainer + run_with_restarts in {run_s:.1f} s; losses "
        + " ".join(f"{x:.4f}" for x in losses) + " (finite)")
    say(f"[train] (a) step {med:.1f} ms (CUDA events, median of {len(timed)} after "
        f"{TRAIN_WARMUP} warm-up; min {min(timed):.1f} max {max(timed):.1f}; warm-up "
        + " ".join(f"{x:.1f}" for x in step_ms[:TRAIN_WARMUP]) + f") -> "
        f"{work['tokens'] / med * 1e3:.0f} tokens/s")
    say(f"[train] (a) operations: model {work['model_flops'] / 1e12:.1f} TFLOP per step "
        f"(6 x {work['matmul_params'] / 1e9:.4f} B matmul weights x {work['tokens']} tokens + "
        f"3 x {work['attn_fwd_flops'] / 1e12:.2f} TFLOP attention forward), executed with the "
        f"remat recompute {work['executed_flops'] / 1e12:.1f} TFLOP; bound {bound_ms:.1f} ms by "
        f"operations at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 (bytes {bytes_ms:.1f} ms) -> "
        f"{bound_ms / med:.1%} of the bound; executed at "
        f"{work['executed_flops'] / med / 1e9:.0f} TFLOP/s")
    say(f"[train] (a) one step under torch.profiler (fresh session): device time "
        f"{kernel_ms:.1f} ms against the median step {med:.1f} ms -> idle "
        f"{1 - kernel_ms / med:.1%} (against the profiled step's own {wall_ms:.1f} ms: "
        f"{1 - kernel_ms / wall_ms:.1%}); "
        f"matrix multiplies {gemm_ms:.1f} ms, the rest {kernel_ms - gemm_ms:.1f} ms; top "
        f"kernels: {top}")
    say(f"[train] (a) memory_allocated: peak {peak / 1e9:.2f} GB ({(peak - base_mem) / 1e9:.2f} "
        f"above the phase's start); after each step "
        + " ".join(f"{m / 1e9:.4f}" for m in mem) + f" GB; drift over steps 3-{n_steps} "
        f"{drift} B (limit {TRAIN_MEM_SLACK}); parameter storage unchanged over {len(ptrs)} steps")
    say(f"[train] (a) checkpoint at step {n_steps}: {written / 1e9:.2f} GB written to "
        f"{ckpt_dir.parent} ({free_after / 1e9:.0f} GB free after; deleted); save_async "
        f"{mgr.save_s:.2f} s (host copy), wait {mgr.wait_s:.2f} s (the write)")
    del trainers, trainer, make_trainer, abstract, batch
    torch.cuda.empty_cache()

    # -- (b) full widths at 2 layers, f32, card against CPU ----------------------
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the f32 checks")
    t0 = time.perf_counter()
    cfg_b = dataclasses.replace(cfg, n_layers=2, window_size=GRAD_WINDOW,
                                param_dtype="float32", activation_dtype="float32")
    par_b = ParallelConfig(attn_impl="chunked", attn_chunk=GRAD_CHUNK, remat="block")
    p_card, _ = lm.init(torch.Generator(device=dev).manual_seed(1), cfg_b, dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    b_cpu = SyntheticTokenPipeline(cfg_b.vocab_size, GRAD_SEQ, 1, seed=1, device="cpu").batch_at(0)
    b_card = tree_map(lambda t: t.to(dev), b_cpu)

    def loss_b(p, b):
        return lm.loss_fn(p, b, cfg_b, par_b)

    l_card, _, g_card = train.value_and_grad(loss_b, p_card, b_card)
    l_cpu, _, g_cpu = train.value_and_grad(loss_b, p_cpu, b_cpu)
    dl = abs(float(l_card) - float(l_cpu))
    g_err, g_ok = _grad_errors(g_card, g_cpu, GRAD_REL_TOL, GRAD_ABS_TOL)
    require(dl <= GRAD_LOSS_TOL, f"(b) loss card vs CPU {dl:.3e}")
    require(g_ok, f"(b) a gradient leaf card vs CPU past {GRAD_REL_TOL:g} max|g| (max {g_err:.3e})")
    optc_b = AdamWConfig(peak_lr=GRAD_LR, warmup_steps=1, total_steps=10)
    new_card, _, _ = adamw_update(p_card, g_card, init_opt_state(p_card, optc_b), optc_b)
    new_cpu, _, _ = adamw_update(p_cpu, g_cpu, init_opt_state(p_cpu, optc_b), optc_b)
    p_err, p_ok = _grad_errors(new_card, new_cpu, 0.0, 2 * GRAD_LR + GRAD_ABS_TOL)
    require(p_ok, f"(b) params after one AdamW step differ by {p_err:.3e} > 2 lr")
    out.update(grad_loss_err=dl, grad_err=g_err, grad_param_err=p_err)
    say(f"[train] (b) {cfg_b.name} widths at 2 layers, f32, TF32 off, window {GRAD_WINDOW}, "
        f"batch 1 x {GRAD_SEQ}, chunks of {GRAD_CHUNK}, remat block: card vs CPU |dloss| "
        f"{dl:.3e} (tol {GRAD_LOSS_TOL:g}), max |dgrad| {g_err:.3e} (every leaf within "
        f"{GRAD_REL_TOL:g} max|g| + {GRAD_ABS_TOL:g}), params after one AdamW step at lr "
        f"{GRAD_LR:g} {p_err:.3e} (tol 2 lr) ({time.perf_counter() - t0:.1f} s)")
    del p_card, p_cpu, g_card, g_cpu, new_card, new_cpu
    torch.cuda.empty_cache()

    # -- (c) every smoke config, f32, card against CPU ---------------------------
    smoke = {}
    par_s = ParallelConfig(attn_impl="naive", remat="none")
    optc_s = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in [a for a in registry.ARCH_IDS if a != "sensor_gsp"]:
        cfg_s = registry.get_smoke(arch)
        p_cpu, _ = lm.init(torch.Generator().manual_seed(2), cfg_s, "cpu")
        p_card = tree_map(lambda t: t.to(dev), p_cpu)
        pipe_s = SyntheticTokenPipeline(cfg_s.vocab_size, 32, 2, seed=3, device="cpu",
                                        frontend_positions=8 if cfg_s.family in ("vlm", "audio")
                                        else 0, d_model=cfg_s.d_model)
        b_cpu = pipe_s.batch_at(0)
        b_card = tree_map(lambda t: t.to(dev), b_cpu)

        def loss_s(p, b, cfg_s=cfg_s):
            return lm.loss_fn(p, b, cfg_s, par_s)

        l_card, _, g_card = train.value_and_grad(loss_s, p_card, b_card)
        l_cpu, _, g_cpu = train.value_and_grad(loss_s, p_cpu, b_cpu)
        dl = abs(float(l_card) - float(l_cpu))
        g_err, g_ok = _grad_errors(g_card, g_cpu, SMOKE_GRAD_REL, SMOKE_GRAD_TOL,
                                   SMOKE_GRAD_REL if arch == "xlstm_350m" else 0.0)
        require(dl <= SMOKE_GRAD_TOL, f"(c) {arch} loss card vs CPU {dl:.3e}")
        require(g_ok, f"(c) {arch} grads card vs CPU (max {g_err:.3e})")
        step_s = train.make_train_step(cfg_s, par_s, optc_s)
        new_card, _, m_card = step_s(p_card, init_opt_state(p_card, optc_s), b_card, donate=True)
        new_cpu, _, _ = step_s(p_cpu, init_opt_state(p_cpu, optc_s), b_cpu, donate=True)
        p_err, p_ok = _grad_errors(new_card, new_cpu, 0.0, 2e-3 + GRAD_ABS_TOL)
        require(p_ok and math.isfinite(float(m_card["loss"])),
                f"(c) {arch} params after one train step differ by {p_err:.3e} > 2 lr")
        smoke[arch] = (dl, g_err, p_err)
    out["smoke"] = smoke
    say(f"[train] (c) smoke configs, f32, card vs CPU |dloss| (tol {SMOKE_GRAD_TOL:g}) / max "
        f"|dgrad| (tol {SMOKE_GRAD_TOL:g} + {SMOKE_GRAD_REL:g} max|g|, xLSTM also + "
        f"{SMOKE_GRAD_REL:g} |g|) / params after one donated train step (tol 2 lr): "
        + ", ".join(f"{a} {e[0]:.1e}/{e[1]:.1e}/{e[2]:.1e}" for a, e in smoke.items()))

    # -- (d) the gossip path: the 100m preset on StackedMesh(8) ----------------------
    t0 = time.perf_counter()
    cfg_g = preset_config("100m")
    optc_g = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=PRESETS["100m"]["steps"])
    pipe_g = SyntheticTokenPipeline(cfg_g.vocab_size, GOSSIP_TRAIN_SEQ, GOSSIP_TRAIN_BATCH,
                                    device=dev)
    mesh = StackedMesh(GOSSIP_RANKS, dev)
    params_g, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg_g, dev)
    n_g = sum(t.numel() for t in tree_leaves(params_g))
    order = gossip.required_order(GOSSIP_RANKS, 1e-3)
    batches = [pipe_g.batch_at(s) for s in range(GOSSIP_TRAIN_STEPS)]

    def par_g(**kw):
        return ParallelConfig(attn_impl="naive", remat="none", microbatches=2,
                              grad_sync="gossip", gossip_order=order, fsdp=False, **kw)

    def run(step, stacked):
        p = tree_map(torch.clone, params_g)
        o = init_opt_state(p, optc_g)
        if stacked:
            p, o = train.replicate(p, GOSSIP_RANKS), train.replicate(o, GOSSIP_RANKS)
        losses, ms = [], []
        for b in batches:
            start, stop = events()
            start.record()
            p, o, m = step(p, o, b)
            stop.record()
            losses.append(float(m["loss"]))
            ms.append(start.elapsed_time(stop))
        return losses, ms

    runs = {}
    for name, kw in (("serial", dict(gossip_buckets=1, gossip_overlap=False)),
                     ("bucketed", dict(gossip_buckets=4, gossip_overlap=False)),
                     ("delay-slot", dict(gossip_buckets=4, gossip_overlap=True))):
        runs[name] = run(jit_train_step(train.make_gossip_train_step(
            cfg_g, par_g(**kw), optc_g, None, mesh)), True)
    runs["barrier"] = run(jit_train_step(train.make_barrier_train_step(
        cfg_g, par_g(), optc_g, None, mesh)), True)
    runs["exact"] = run(jit_train_step(train.make_train_step(cfg_g, par_g(), optc_g)), False)
    sched = max(abs(a - b) for name in ("bucketed", "delay-slot")
                for a, b in zip(runs[name][0], runs["serial"][0]))
    require(sched <= SCHEDULE_TOL, f"(d) gossip schedules differ by {sched:.3e}")
    for name in ("serial", "bucketed", "delay-slot", "barrier"):
        for lg, le in zip(runs[name][0], runs["exact"][0]):
            require(abs(lg - le) < 0.15 * abs(le) + 0.05, f"(d) {name} loss {lg} vs exact {le}")
    # One bucketed sync of a gradient of this model per rank, timed alone.
    grads = train.replicate(tree_map(torch.randn_like, params_g), GOSSIP_RANKS)
    plan = train.build_bucket_plan(params_g, 4)

    def one_sync():
        flats = train.pack_buckets(plan, grads)
        train.unpack_buckets(plan, [gossip.chebyshev_gossip_mean(f, mesh, order=order)
                                    for f in flats])

    sync_ms = median_ms(one_sync, reps=3, warmup=1)
    out["gossip"] = dict(runs)
    out["sync_ms"] = sync_ms
    say(f"[train] (d) {cfg_g.name} ({n_g / 1e6:.1f} M params per rank, f32) on "
        f"StackedMesh({GOSSIP_RANKS}), batch {GOSSIP_TRAIN_BATCH} x {GOSSIP_TRAIN_SEQ}, 2 "
        f"microbatches, gossip order {order}: losses over {GOSSIP_TRAIN_STEPS} steps "
        + "; ".join(f"{k} " + " ".join(f"{x:.5f}" for x in v[0]) for k, v in runs.items())
        + f"; schedules agree within {sched:.2e} (tol {SCHEDULE_TOL:g}); gossip tracks exact")
    say("[train] (d) ms per step (CUDA events; first step includes warm-up): "
        + "; ".join(f"{k} " + " ".join(f"{x:.1f}" for x in v[1]) for k, v in runs.items())
        + f"; one bucketed sync (K 4) {sync_ms:.1f} ms -> {sync_ms / runs['bucketed'][1][-1]:.1%} "
        f"of a bucketed step, {2 * sync_ms / runs['delay-slot'][1][-1]:.1%} of a delay-slot step "
        f"(2 syncs) ({time.perf_counter() - t0:.1f} s)")
    del params_g, grads, runs, mesh
    torch.cuda.empty_cache()

    # -- (e) the entry points, and a restart ------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        runs_e = {}
        for name, cmd in (("launch.train", ["-m", "repro_torch.launch.train", "--arch",
                                            "gemma2_2b", "--smoke", "--steps", "20",
                                            "--ckpt-dir", os.path.join(tmp, "launch"), "--device", str(dev)]),
                          ("train_lm", ["-m", "repro_torch.train_lm", "--preset", "tiny",
                                        "--device", str(dev)])):
            proc = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                                  timeout=300, env={**env, "TMPDIR": tmp}, cwd=ROOT)
            require(proc.returncode == 0, f"(e) {name} failed: {proc.stderr[-2000:]}")
            rec = json.loads(proc.stdout[proc.stdout.index("{"):proc.stdout.rindex("}") + 1])
            runs_e[name] = rec
        require(runs_e["launch.train"]["steps"] == 20 and runs_e["launch.train"]["restarts"] == 0
                and math.isfinite(runs_e["launch.train"]["loss_last5"]), "(e) launcher record")
        require(runs_e["train_lm"]["steps"] == 3, "(e) train_lm record")

        cfg_r = registry.get_smoke("gemma2_2b")
        optc_r = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=RESTART_STEPS)
        pipe_r = SyntheticTokenPipeline(cfg_r.vocab_size, 32, 4, device=dev)
        step_r = jit_train_step(train.make_train_step(cfg_r, ParallelConfig(
            attn_impl="naive", remat="none"), optc_r))

        def restart_run(name, fail_at):
            d = os.path.join(tmp, name)
            mgr_r = CheckpointManager(d, keep=3)
            injector = FailureInjector(fail_at)
            made = []

            def make(start):
                params, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg_r, dev)
                opt = init_opt_state(params, optc_r)
                if start:
                    snap = restore(d, start, {"params": params, "opt": opt}, device=dev)
                    params, opt = snap["params"], snap["opt"]
                made.append(start)
                return train.Trainer(train_step=step_r, pipeline=pipe_r, ckpt=mgr_r,
                                     params=params, opt_state=opt, ckpt_every=2,
                                     failure_injector=injector)

            res = run_with_restarts(make, RESTART_STEPS, latest_step_fn=lambda: latest_step(d))
            return res, made

        whole, _ = restart_run("whole", ())
        resumed, starts = restart_run("resumed", (RESTART_FAIL_AT,))
        require(resumed["final_step"] == RESTART_STEPS and resumed["restarts"] == 1,
                f"(e) restart ended at {resumed['final_step']} after {resumed['restarts']}")
        tail = whole["losses"][starts[-1]:]
        r_err = max(abs(a - b) for a, b in zip(resumed["losses"], tail))
        require(len(tail) == len(resumed["losses"]) and r_err <= RESTART_TOL,
                f"(e) resumed losses differ from the uninterrupted run's by {r_err:.3e}")
    out.update(entry=runs_e, restart_err=r_err)
    say(f"[train] (e) python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 20: "
        f"{runs_e['launch.train']}; python -m repro_torch.train_lm --preset tiny: "
        f"{ {k: v for k, v in runs_e['train_lm'].items() if k != 'ckpt_dir'} }")
    say(f"[train] (e) restart: failure at step {RESTART_FAIL_AT} of {RESTART_STEPS}, resumed from "
        f"step {starts[-1]}, final step {resumed['final_step']}, restarts {resumed['restarts']}; "
        f"resumed losses vs uninterrupted max |d| {r_err:.2e} (tol {RESTART_TOL:g}) "
        f"({time.perf_counter() - t0:.1f} s)")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[train] phase 13 took {out['seconds']:.1f} s")
    return out


def analysis_phase(dev, lm_out: dict, train_out: dict) -> dict:
    """Phase 14: the dry-run tooling (``repro_torch.launch``) on ``meta``
    tensors, held against what phases 12 and 13 measured on the card (see
    the module docstring). Nothing here runs on the card."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.cells import Cell, cell_skip_reason
    from repro_torch.launch.mesh import ProductionMesh
    from repro_torch.launch.roofline import HW
    from repro_torch.models.config import ParallelConfig, ShapeConfig

    t_phase = time.perf_counter()
    one_card = ProductionMesh(("data", "model"), (1, 1))
    out = {}
    require((HW.peak_flops, HW.hbm_bw) == (BF16_FLOPS_PER_S, HBM_BYTES_PER_S),
            "launch.roofline.HW and this script's H100 rates differ")
    require(HW.hbm_capacity <= torch.cuda.get_device_properties(dev).total_memory,
            "launch.roofline.HW holds more memory than the card")

    # -- (a) the dry run: Gemma-2 2B's cells and the GSP cells, both meshes ------
    t0 = time.perf_counter()
    records = []
    for shape in dryrun.SHAPES.values():
        reason = cell_skip_reason(Cell(ANALYSIS_ARCH, shape))
        if reason:
            say(f"[analysis] (a) {ANALYSIS_ARCH}.{shape.name}: skipped ({reason})")
            continue
        for multi_pod in (False, True):
            (rec,) = dryrun.main(["--arch", ANALYSIS_ARCH, "--shape", shape.name]
                                 + (["--multi-pod"] if multi_pod else []))
            records.append(rec)
    gsp = dryrun.main(["--gsp", "--both-meshes"])
    for rec in records + gsp:
        require("error" not in rec, f"dry-run error record {rec}")
        say(f"[analysis] (a) {json.dumps(rec, sort_keys=True)}")
    for multi_pod in (False, True):
        by = {r["backend"]: r for r in gsp if r["multi_pod"] == multi_pod}
        halo, ag = by["halo"], by["allgather"]
        require(halo["collective_bytes_per_device"] < 0.25 * ag["hlo_bytes_per_device"],
                f"GSP halo collective bytes not under 0.25 x allgather's bytes ({multi_pod=})")
        require(ag["memory_s"] > 5 * halo["memory_s"],
                f"GSP allgather memory_s not over 5 x halo's ({multi_pod=})")
        require(halo["measured_words_per_matvec"] == halo["halo_words_per_matvec"] * GSP_F,
                f"GSP halo words per matvec {halo['measured_words_per_matvec']} != "
                f"2 side (P - 1) F = {halo['halo_words_per_matvec'] * GSP_F}")
        say(f"[analysis] (a) GSP claims hold on {halo['n_chips']} cards: halo collective "
            f"{halo['collective_bytes_per_device'] / 1e6:.3f} MB < 0.25 x allgather bytes "
            f"{ag['hlo_bytes_per_device'] / 1e6:.1f} MB; allgather memory_s "
            f"{ag['memory_s'] * 1e3:.4f} ms = {ag['memory_s'] / halo['memory_s']:.1f} x halo's "
            f"{halo['memory_s'] * 1e3:.4f} ms (> 5); halo words per matvec "
            f"{halo['measured_words_per_matvec']:.0f} = 2 side (P - 1) F")
    out["dryrun_s"] = time.perf_counter() - t0
    say(f"[analysis] (a) {len(records)} {ANALYSIS_ARCH} records and {len(gsp)} GSP records "
        f"in {out['dryrun_s']:.1f} s, no error record")

    # -- (b) phase 13's step, analysed on one card --------------------------------
    # The dry run's own cell builder and trace (``build_cell``,
    # ``trace_costs``) at phase 13's shape and parallel config.
    t0 = time.perf_counter()
    cfg = registry.get(TRAIN_ARCH)
    par = ParallelConfig(attn_impl="chunked", attn_chunk=TRAIN_CHUNK, remat="block",
                         microbatches=TRAIN_MICRO)
    cell = dryrun.build_cell(TRAIN_ARCH, ShapeConfig("phase13", TRAIN_SEQ, TRAIN_BATCH, "train"),
                             mesh=one_card, par=par)
    w = dryrun.trace_costs(cell)
    held = cell.arguments["params"] + cell.arguments["opt_state"]
    flop_ratio = w.matmul_flops / train_out["executed_flops"]
    predicted_peak = cell.memory["argument_bytes"] + w.peak_live_bytes
    measured_peak = train_out["peak_bytes"] - train_out["base_bytes"]
    peak_ratio = predicted_peak / measured_peak
    require(abs(flop_ratio - 1) <= ANALYSIS_FLOP_TOL,
            f"analysed train FLOPs {w.matmul_flops:.4e} vs executed "
            f"{train_out['executed_flops']:.4e}")
    require(held == train_out["held_bytes"],
            f"analysed param + AdamW bytes {held:.0f} != the card's {train_out['held_bytes']}")
    require(abs(peak_ratio - 1) <= ANALYSIS_PEAK_TOL,
            f"analysed peak {predicted_peak / 1e9:.2f} GB vs measured {measured_peak / 1e9:.2f} GB")
    train_ms = max(w.matmul_flops / HW.peak_flops, w.hbm_bytes / HW.hbm_bw) * 1e3
    out.update(train_flop_ratio=flop_ratio, train_peak_ratio=peak_ratio,
               train_predicted_ms=train_ms, train_trip_counts=w.while_trip_counts)
    say(f"[analysis] (b) phase 13's step ({cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_MICRO} microbatches, chunked {TRAIN_CHUNK}, remat block) on meta, one card, "
        f"trip counts {w.while_trip_counts} ({time.perf_counter() - t0:.1f} s): matmul "
        f"{w.matmul_flops / 1e12:.2f} TFLOP = {flop_ratio:.4f} x train_work's executed "
        f"{train_out['executed_flops'] / 1e12:.2f} (tol {ANALYSIS_FLOP_TOL:g}); param + AdamW "
        f"bytes {held:.0f} = the card's after init; peak {predicted_peak / 1e9:.2f} GB "
        f"(arguments {cell.memory['argument_bytes'] / 1e9:.2f} + live "
        f"{w.peak_live_bytes / 1e9:.2f}) = "
        f"{peak_ratio:.3f} x phase 13's {measured_peak / 1e9:.2f} GB above its start (tol "
        f"{ANALYSIS_PEAK_TOL:g}); eager op-boundary bytes {w.hbm_bytes / 1e12:.2f} TB -> "
        f"roofline {train_ms:.1f} ms beside the measured step "
        f"{train_out['step_median_ms']:.1f} ms (device busy {train_out['kernel_ms']:.1f} ms)")

    # -- (c) phase 12's prefill and decode step --------------------------------------
    # The dry run's prefill cell traces ``lm.forward(last_only=True)``, as
    # the reference's does: phase 12's ``lm.prefill`` also writes the cache.
    t0 = time.perf_counter()
    cfg = registry.get(LM_ARCH)
    s_max = LM_PROMPT + LM_NEW + 8
    work = lm_work(cfg, LM_BATCH, LM_PROMPT, s_max, lm_out["param_bytes"], lm_out["n_params"])
    for name, seq, measured in (("prefill", LM_PROMPT, lm_out["prefill_kernel_ms"]),
                                ("decode", s_max, lm_out["decode_kernel_ms"])):
        cell = dryrun.build_cell(LM_ARCH, ShapeConfig(f"phase12_{name}", seq, LM_BATCH, name),
                                 mesh=one_card, par=launch_serve.PAR)
        w = dryrun.trace_costs(cell)
        flops_ms = w.matmul_flops / HW.peak_flops * 1e3
        bytes_ms = w.hbm_bytes / HW.hbm_bw * 1e3
        out[f"{name}_predicted_ms"] = max(flops_ms, bytes_ms)
        out[f"{name}_bytes"] = w.hbm_bytes
        say(f"[analysis] (c) phase 12's {name} ({cfg.name}, batch {LM_BATCH}, prompt "
            f"{LM_PROMPT}, s_max {s_max}, naive attention) on meta: "
            f"{w.matmul_flops / 1e12:.4f} TFLOP ({flops_ms:.3f} ms at "
            f"{HW.peak_flops / 1e12:.0f} TFLOP/s), eager op-boundary bytes "
            f"{w.hbm_bytes / 1e9:.3f} GB ({bytes_ms:.3f} ms at 3.35 TB/s) -> predicted "
            f"{max(flops_ms, bytes_ms):.3f} ms beside the measured device busy {measured:.3f} ms "
            f"(x{measured / max(flops_ms, bytes_ms):.2f})")
    require(out["decode_bytes"] >= work["decode_bytes"],
            f"analysed decode bytes {out['decode_bytes']:.4e} under lm_work's "
            f"{work['decode_bytes']:.4e} (every weight and the cache are read)")
    say(f"[analysis] (c) decode analysed bytes {out['decode_bytes'] / 1e9:.3f} GB >= lm_work's "
        f"{work['decode_bytes'] / 1e9:.3f} GB (weights + the s_max cache) "
        f"({time.perf_counter() - t0:.1f} s)")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[analysis] phase 14 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    # Keep the profiler's CUPTI attached between sessions: with the default
    # teardown after each one, sessions in a short test process on the
    # H100 traced no device record at all every second or third time.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout (src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import chebyshev as tcheb
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
    builds = {"cheb_union_kernel": 0, "cheb_step_strip_kernel": 0, "cheb_adjoint_union_kernel": 0}
    for name, info in sorted(ptxas.items()):
        m = re.search(r"(cheb_(?:adjoint_union|union|step|step_strip)_kernel)I(.*?)EEv", name)
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
    require(builds["cheb_adjoint_union_kernel"] == 2, f"ptxas reported "
            f"{builds['cheb_adjoint_union_kernel']} adjoint kernels (want B 8, 16)")

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

    def check_adjoint(blocks, cols, a, coeffs, lmax, where, f_tile=None):
        before = cheb_bsr.launch_counts()
        got = cheb_bsr.cheb_adjoint_union_cuda(blocks, cols, a, coeffs=coeffs, lmax=lmax,
                                               f_tile=f_tile)
        torch.cuda.synchronize()
        require(cheb_bsr.launch_counts() == (before[0], before[1], before[2] + 1),
                f"cheb_adjoint_union {where}: launches {before} -> {cheb_bsr.launch_counts()}")
        want = tref.cheb_adjoint_union_ref(blocks, cols, a, coeffs, lmax)
        err = (got - want).abs()
        ok = bool((err <= ADJOINT_KERNEL_TOL + ADJOINT_KERNEL_TOL * want.abs()).all())
        require(ok, f"cheb_adjoint_union {where}: max err {err.max():.3e}")
        say(f"[kernels] cheb_adjoint_union {where} max|kernel-plain| {float(err.max()):.3e} "
            f"of max|plain| {float(want.abs().max()):.3f} (tol {ADJOINT_KERNEL_TOL:g}) ok")
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
    # The solvers' gram at the deployment shape: eta = 1, order 2M.
    union_err = max(union_err, check_union(bell.blocks, bell.cols, f_deploy,
                                           filt.gram_coeffs[None], lmax,
                                           f"deploy gram eta=1 M={2 * ORDER}"))
    # The adjoint kernel at the lasso's (eta, N, F), a ragged last pass at
    # B = 8 and 16, and one squeezed column.
    a_deploy = rand(filt.eta, n_pad, DEPLOY_F)
    adjoint_err = check_adjoint(bell.blocks, bell.cols, a_deploy, filt.coeffs, lmax,
                                f"deploy eta={filt.eta} M={ORDER} F={DEPLOY_F}")
    a_ragged = a_deploy[:, :, :100].contiguous()
    adjoint_err = max(adjoint_err, check_adjoint(bell.blocks, bell.cols, a_ragged, filt.coeffs,
                                                 lmax, "deploy B=8 F=100 f_tile=32", f_tile=32))
    adjoint_err = max(adjoint_err, check_adjoint(bell16.blocks, bell16.cols, a_ragged, filt.coeffs,
                                                 lmax, "deploy B=16 F=100"))
    adjoint_err = max(adjoint_err, check_adjoint(bell.blocks, bell.cols,
                                                 a_deploy[:, :, 0].contiguous(), filt.coeffs,
                                                 lmax, "deploy F=1 (eta, N)"))

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
    a0 = cheb_bsr.launch_counts()
    back_deploy = filt.adjoint(out_fused, backend="bsr")
    a1 = cheb_bsr.launch_counts()
    adjoint_launches = tuple(y - x for x, y in zip(a0, a1))
    expect_launches("bsr adjoint", adjoint_launches, (0, 0, 1))
    require(back_deploy.shape == (DEPLOY_N, DEPLOY_F) and bool(torch.isfinite(back_deploy).all()),
            f"bsr adjoint output {tuple(back_deploy.shape)}")
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
        f"(tol {AGREE_TOL:g}); launches union {u1 - u0} per fused apply, step {s2 - s1} per "
        f"stepwise apply, adjoint {adjoint_launches[2]} per bsr adjoint")
    say(f"[main path] launches in the counted run: cheb_union {main_union}, "
        f"cheb_step {main_step}")

    # ---- 5. solvers, each solve counted ---------------------------------------
    count = LaunchCounter(cheb_bsr)
    solved = solver_phase(dev, count, filt, signal, check_union, check_step)
    union_err = max(union_err, solved["union_err"])
    step_err = max(step_err, solved["step_err"])
    require(count.union > 0 and count.step > 0, "a kernel of the solver path was never launched")
    require(count.adjoint > 0, "the adjoint kernel was never launched on the solver path")
    say(f"[solvers] launches in the counted solves: cheb_union {count.union}, "
        f"cheb_step {count.step}, cheb_adjoint_union {count.adjoint}")
    main_union += count.union
    main_step += count.step

    # ---- 6. timing ------------------------------------------------------------
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
            cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a_deploy,
                                             coeffs=filt.coeffs, lmax=lmax)
        torch.cuda.synchronize()
    device_ms = {}
    for ev in prof.key_averages():
        for name in ("cheb_union_kernel", "cheb_step_strip_kernel", "cheb_adjoint_union_kernel"):
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
    union_bytes, union_flops = union_work(nnz_l, tile_bytes, n_pad, DEPLOY_F, filt.eta, ORDER)
    step_bytes = tile_bytes + 3 * sig * 4
    step_flops = 2 * nnz_l * DEPLOY_F + 5 * sig
    ub, ub_by = bound(union_bytes, union_flops)
    # The solvers' gram: one union apply at eta = 1 and order 2M.
    gram_order = 2 * ORDER
    gram_bytes, gram_flops = union_work(nnz_l, tile_bytes, n_pad, DEPLOY_F, 1, gram_order)
    gb, gb_by = bound(gram_bytes, gram_flops)
    sb, sb_by = bound(step_bytes, step_flops)
    say(f"[timing] cheb_union kernel {union_ms:.3f} ms (plain {union_plain_ms:.3f}, bound "
        f"{ub:.4f} by {ub_by}: {union_bytes / 1e6:.1f} MB, {union_flops / 1e9:.2f} GFLOP); "
        f"cheb_step kernel {step_ms:.3f} ms (plain {step_plain_ms:.3f}, bound {sb:.4f} by "
        f"{sb_by}: {step_bytes / 1e6:.1f} MB, {step_flops / 1e9:.3f} GFLOP; bf16 signal "
        f"{step_bf16_ms:.3f}; library addmm on sparse {lib_format} {step_lib_ms:.3f}, "
        f"max|addmm-plain| {float(lib_err.max()):.3e} (tol {F32_STEP_TOL:g}))")
    # The adjoint kernel against its plain version and the plain
    # recurrence on eta-stacked columns (the route it replaced), on the
    # same (eta, N, F) input; its bound counts its own work: M matvecs on
    # F columns and the fused contraction.
    adjoint_ms = median_ms(lambda: cheb_bsr.cheb_adjoint_union_cuda(
        bell.blocks, bell.cols, a_deploy, coeffs=filt.coeffs, lmax=lmax))
    adjoint_plain_ms = median_ms(lambda: tref.cheb_adjoint_union_ref(
        bell.blocks, bell.cols, a_deploy, filt.coeffs, lmax))
    adjoint_recurrence_ms = median_ms(lambda: tcheb.cheb_adjoint_apply(
        lambda v: tref.bsr_matvec_ref(bell, v.reshape(n_pad, -1)).reshape(v.shape), a_deploy,
        filt.coeffs, lmax), reps=5, warmup=1)
    adjoint_bytes = tile_bytes + (filt.eta + 1) * sig * 4 + filt.eta * (ORDER + 1) * 4
    adjoint_flops = ORDER * (2 * nnz_l * DEPLOY_F + 5 * sig) + filt.eta * (ORDER + 1) * 2 * sig
    ab, ab_by = bound(adjoint_bytes, adjoint_flops)
    say(f"[timing] cheb_adjoint_union kernel {adjoint_ms:.3f} ms (device "
        f"{device_ms.get('cheb_adjoint_union_kernel', float('nan')):.4f}; plain Clenshaw "
        f"{adjoint_plain_ms:.3f}, plain recurrence on eta*F columns {adjoint_recurrence_ms:.3f}; "
        f"bound {ab:.4f} by {ab_by}: {adjoint_bytes / 1e6:.1f} MB, {adjoint_flops / 1e9:.2f} "
        f"GFLOP)")
    st = solver_timing(solved["deploy_problem"], bell, tiling.f_tile)
    say(f"[timing] cheb_union at the gram's shape (eta=1, M={gram_order}) "
        f"{st['gram_union_kernel']:.3f} ms, bound {gb:.4f} by {gb_by}: "
        f"{gram_bytes / 1e6:.1f} MB, {gram_flops / 1e9:.2f} GFLOP")
    say(f"[timing] solvers, median ms at N={DEPLOY_N} F={DEPLOY_F} eta={filt.eta} M={ORDER}: "
        f"FISTA iteration bsr {st['fista_bsr']:.3f} (forward apply {st['forward_bsr']:.3f}, "
        f"adjoint {st['adjoint_bsr']:.3f}, rest {st['rest_bsr']:.3f}), dense "
        f"{st['fista_dense']:.3f} (forward {st['forward_dense']:.3f}, adjoint "
        f"{st['adjoint_dense']:.3f}, rest {st['rest_dense']:.3f}); CG iteration bsr "
        f"{st['cg_iteration_bsr']:.3f} (gram M={2 * ORDER} {st['gram_bsr']:.3f}, its union kernel "
        f"{st['gram_union_kernel']:.3f} with {st['gram_grid_barriers']} grid barriers; rest "
        f"{st['cg_rest_bsr']:.3f}); tol-mode host sync per iteration, median of 5 pairs of "
        f"40-iteration CG runs {statistics.median(st['tol_sync']):.4f} (pairs "
        + " ".join(f"{d:.4f}" for d in st["tol_sync"]) + ")")

    # ---- 7. distributed (Algorithm 1 on a stacked 8-rank mesh) ----------------
    before = cheb_bsr.launch_counts()
    distributed_phase(dev, filt, signal, solved["deploy_fista_dense"])
    require(cheb_bsr.launch_counts() == before, "the distributed phase launched a bsr kernel")

    # ---- 8. multi-shift joint filters, each run counted ------------------------
    ms_count = LaunchCounter(cheb_bsr)
    ms = multishift_phase(dev, ms_count, check_union, check_step)
    union_err = max(union_err, ms["union_err"])
    step_err = max(step_err, ms["step_err"])
    require(ms_count.union > 0 and ms_count.step > 0,
            "a kernel of the multi-shift path was never launched")
    require(ms_count.adjoint == 0, "the multi-shift path launched the adjoint kernel")
    say(f"[multishift] launches in the counted runs: cheb_union {ms_count.union}, "
        f"cheb_step {ms_count.step}")
    main_union += ms_count.union
    main_step += ms_count.step
    mst = multishift_timing(ms)
    ms_orders = ms["filt"].orders

    # ---- 9. streaming and churn, every push counted -----------------------------
    st_count = LaunchCounter(cheb_bsr)
    sp = stream_phase(dev, st_count, filt, signal, check_union)
    union_err = max(union_err, sp["union_err"])
    require(st_count.union > 0, "a kernel of the streaming path was never launched")
    say(f"[stream] launches in the counted pushes and solves: cheb_union {st_count.union}, "
        f"cheb_step {st_count.step}, cheb_adjoint_union {st_count.adjoint}")
    main_union += st_count.union
    main_step += st_count.step

    # ---- 10. the serving layer, every engine and program run counted -------------
    sv_count = LaunchCounter(cheb_bsr)
    sv = serve_phase(dev, sv_count, filt)
    union_err = max(union_err, sv["union_err"])
    step_err = max(step_err, sv["step_err"])
    require(sv_count.union > 0 and sv_count.step > 0,
            "a kernel of the serving path was never launched")
    say(f"[serve] launches in the counted engine and program runs: cheb_union "
        f"{sv_count.union}, cheb_step {sv_count.step}, cheb_adjoint_union {sv_count.adjoint}")
    main_union += sv_count.union
    main_step += sv_count.step

    # ---- 11. gossip consensus and the training substrate ------------------------
    before = cheb_bsr.launch_counts()
    gossip_phase(dev)
    require(cheb_bsr.launch_counts() == before, "the gossip phase launched a bsr kernel")

    # ---- 12. LM serving: Gemma-2 2B at full width, numerics, smoke configs ------
    lm_out = lm_phase(dev)
    require(cheb_bsr.launch_counts() == before, "the LM serving phase launched a bsr kernel")

    # ---- 13. training: Gemma-2 2B at full width, numerics, gossip, entry points --
    train_out = train_phase(dev)
    require(cheb_bsr.launch_counts() == before, "the training phase launched a bsr kernel")

    # ---- 14. the dry-run tooling, held against phases 12 and 13 ------------------
    analysis_phase(dev, lm_out, train_out)
    require(cheb_bsr.launch_counts() == before, "the analysis phase launched a bsr kernel")
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
            "gram_ms": st["gram_union_kernel"], "gram_bound_ms": gb, "gram_bound_by": gb_by,
            "multishift_launches": ms_count.union,
            "multishift_launches_per_apply": ms_orders[0] + 1,
            "multishift_inner_ms": mst["inner_ms"], "multishift_inner_plain_ms":
                mst["inner_plain_ms"], "multishift_inner_bound_ms": mst["inner_bound_ms"],
            "multishift_inner_bound_by": mst["inner_bound_by"],
            "stream_launches": st_count.union,
            "serve_launches": sv_count.union,
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
            "multishift_launches": ms_count.step,
            "multishift_launches_per_apply": ms_orders[1] * (ms_orders[0] + 1),
            "serve_launches": sv_count.step,
        },
        {
            "name": "cheb_adjoint_union", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cheb_bsr.cu",
            "replaces": None,  # the reference runs the adjoint as the plain recurrence
            "launches": adjoint_launches[2] + count.adjoint + st_count.adjoint
                + sv_count.adjoint,
            "launches_per_adjoint": adjoint_launches[2], "max_abs_err": adjoint_err,
            "ms": adjoint_ms, "device_ms": device_ms.get("cheb_adjoint_union_kernel"),
            "plain_ms": adjoint_plain_ms, "plain_recurrence_ms": adjoint_recurrence_ms,
            "bound_ms": ab, "bound_by": ab_by, "library_ms": None,
            "stream_launches": st_count.adjoint, "serve_launches": sv_count.adjoint,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
