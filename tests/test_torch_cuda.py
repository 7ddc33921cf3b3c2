"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device (decided
inside the ``cuda_device`` fixture, never at import). On a card run them
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.filters import GraphFilter
from repro_torch.kernels import cheb_bsr
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(n_rows, k_max, block, f, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    blocks = torch.randn(n_rows, k_max, block, block, generator=gen)
    cols = torch.stack([torch.randperm(n_rows, generator=gen)[:k_max] for _ in range(n_rows)])
    t1 = torch.randn(n_rows * block, f, generator=gen)
    t2 = torch.randn(n_rows * block, f, generator=gen)
    return [x.to(device) for x in (blocks, cols.to(torch.int32), t1, t2)]


@pytest.mark.parametrize(
    "block,f,f_tile",
    [(8, 1, 16), (8, 33, 16), (16, 128, 16), (4, 33, 16), (8, 100, 32), (16, 64, None)],
    ids=["b8-f1", "b8-f33", "b16-f128", "b4-generic", "b8-ragged", "b16-f64"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first", [False, True])
def test_step_kernel_matches_plain(cuda_device, block, f, f_tile, dtype, first):
    # B = 8 and 16 take the strip kernel, B = 4 the generic one; F = 100
    # with f_tile=32 is three full slabs and a ragged one of 4 columns.
    blocks, cols, t1, t2 = _operands(12, 3, block, f, cuda_device)
    blocks, t1, t2 = blocks.to(dtype), t1.to(dtype), t2.to(dtype)
    before = cheb_bsr.cheb_step_cuda.launches
    got = cheb_bsr.cheb_step_cuda(blocks, cols, t1, t2, alpha=3.7, first=first, f_tile=f_tile)
    torch.cuda.synchronize()
    assert cheb_bsr.cheb_step_cuda.launches == before + 1
    want = tref.cheb_step_ref(blocks, cols, t1, t2, 3.7, first=first)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [8, 4])
def test_step_kernel_refuses_signals_past_32_bit_indices(cuda_device, block):
    # Expanded views: N * F = 2**31 elements without allocating them.
    n_rows, f = 2**20 // block, 2**11
    blocks = torch.zeros(1, 1, block, block, device=cuda_device).expand(n_rows, 1, block, block)
    cols = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device).expand(n_rows, 1)
    t = torch.zeros(1, 1, device=cuda_device).expand(n_rows * block, f)
    before = cheb_bsr.cheb_step_cuda.launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        cheb_bsr.cheb_step_cuda(blocks, cols, t, t, alpha=2.0)
    assert cheb_bsr.cheb_step_cuda.launches == before


@pytest.mark.parametrize("krylov", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "block,f,eta,order,f_tile",
    [(8, 40, 1, 1, None), (8, 40, 3, 12, 5), (8, 40, 10, 20, None), (16, 40, 3, 12, None),
     (8, 100, 3, 12, 32), (16, 100, 5, 20, 32), (16, 40, 10, 20, None)],
    ids=["order1", "ftile5", "eta10", "b16", "ragged", "b16-ragged", "b16-eta10"],
)
def test_union_kernel_matches_plain(cuda_device, krylov, block, f, eta, order, f_tile):
    # Laplacian tiles: the recurrence is stable only for a spectrum inside
    # [0, lmax]; on random tiles rounding differences grow with the order.
    # f_tile=32 at F = 100 is three full passes and a ragged one; eta = 10
    # at B = 16 is three multiplier groups of 4.
    g = tgraph.random_sensor_graph(torch.Generator().manual_seed(order), 256, 0.1, 0.11,
                                   device=cuda_device)
    lmax = float(g.lmax_bound())
    bell = tref.bsr_from_dense(g.laplacian(), block)
    blocks, cols = bell.blocks, bell.cols
    f = torch.randn(256, f, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    coeffs = np.random.RandomState(order).randn(eta, order + 1) / (1 + np.arange(order + 1))
    before = cheb_bsr.cheb_union_cuda.launches
    got = cheb_bsr.cheb_union_cuda(blocks, cols, f, coeffs=coeffs, lmax=lmax,
                                   f_tile=f_tile, krylov_dtype=krylov)
    torch.cuda.synchronize()
    assert cheb_bsr.cheb_union_cuda.launches == before + 1
    want = tref.cheb_union_ref(blocks, cols, f, coeffs, lmax, krylov_dtype=krylov)
    if krylov == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert float((got - want).abs().max() / want.abs().max()) < 16 * 2.0**-8


def test_union_kernel_refuses_an_unbuilt_block_size(cuda_device):
    g = tgraph.random_sensor_graph(torch.Generator().manual_seed(0), 256, 0.1, 0.11,
                                   device=cuda_device)
    bell = tref.bsr_from_dense(g.laplacian(), 32)
    f = torch.randn(256, 4, device=cuda_device)
    before = cheb_bsr.cheb_union_cuda.launches
    with pytest.raises(ValueError, match="built for B"):
        cheb_bsr.cheb_union_cuda(bell.blocks, bell.cols, f, coeffs=[[1.0, 0.5]],
                                 lmax=float(g.lmax_bound()))
    assert cheb_bsr.cheb_union_cuda.launches == before


def _adjoint_operands(device, block, f, eta, order, squeeze=False):
    """A 256-node sensor-graph Laplacian tiled at ``block``, an (eta, N, F)
    input (or (eta, N) when ``squeeze``) and random coefficients."""
    g = tgraph.random_sensor_graph(torch.Generator().manual_seed(order), 256, 0.1, 0.11,
                                   device=device)
    bell = tref.bsr_from_dense(g.laplacian(), block)
    shape = (eta, 256) if squeeze else (eta, 256, f)
    a = torch.randn(*shape, generator=torch.Generator().manual_seed(eta)).to(device)
    coeffs = np.random.RandomState(order).randn(eta, order + 1) / (1 + np.arange(order + 1))
    return bell, a, coeffs, float(g.lmax_bound())


@pytest.mark.parametrize(
    "block,f,eta,order,f_tile,squeeze",
    [(8, 40, 5, 20, None, False), (16, 40, 5, 20, None, False), (8, 100, 5, 20, 32, False),
     (16, 100, 3, 12, 32, False), (8, 40, 10, 20, None, False), (16, 40, 10, 20, None, False),
     (8, 1, 5, 20, None, True), (16, 1, 5, 20, None, True), (8, 40, 2, 1, None, False)],
    ids=["b8", "b16", "ragged", "b16-ragged", "eta10", "b16-eta10", "f1", "b16-f1", "order1"],
)
def test_adjoint_kernel_matches_plain(cuda_device, block, f, eta, order, f_tile, squeeze):
    # f_tile=32 at F = 100 is three full passes and a ragged one of 4
    # columns; an (eta, N) input is one column and comes back (N,).
    bell, a, coeffs, lmax = _adjoint_operands(cuda_device, block, f, eta, order, squeeze)
    before = cheb_bsr.launch_counts()
    got = cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a, coeffs=coeffs, lmax=lmax,
                                           f_tile=f_tile)
    torch.cuda.synchronize()
    assert cheb_bsr.launch_counts() == (before[0], before[1], before[2] + 1)
    want = tref.cheb_adjoint_union_ref(bell.blocks, bell.cols, a, coeffs, lmax)
    assert got.shape == want.shape == ((256,) if squeeze else (256, f))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_adjoint_kernel_gives_nan_rows_for_an_out_of_range_column(cuda_device):
    bell, a, coeffs, lmax = _adjoint_operands(cuda_device, 8, 4, 2, 6)
    cols = bell.cols.clone()
    cols[5, 0] = bell.n_block_rows  # one past the last block row
    got = cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, cols, a, coeffs=coeffs, lmax=lmax)
    assert bool(torch.isnan(got[5 * 8:6 * 8]).all())


def test_adjoint_kernel_refuses_an_unbuilt_block_size(cuda_device):
    bell, a, coeffs, lmax = _adjoint_operands(cuda_device, 32, 4, 2, 6)
    before = cheb_bsr.launch_counts()
    with pytest.raises(ValueError, match="built for B"):
        cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a, coeffs=coeffs, lmax=lmax)
    assert cheb_bsr.launch_counts() == before


def test_bsr_adjoint_launches_one_adjoint_kernel(cuda_device):
    gen = torch.Generator().manual_seed(0)
    g = tgraph.connected_sensor_graph(gen, n=500, device=cuda_device)
    filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(float(g.lmax_bound()), 4), 20,
                                        graph=g)
    a = filt.apply(torch.randn(500, 3, generator=gen).to(cuda_device), backend="dense")
    dense = filt.adjoint(a, backend="dense")
    cheb_bsr.reset_launch_counts()
    fused = filt.adjoint(a, backend="bsr")
    torch.cuda.synchronize()
    assert cheb_bsr.launch_counts() == (0, 0, 1)
    plain = filt.adjoint(a.double(), backend="bsr")  # float64: the plain recurrence
    assert cheb_bsr.launch_counts() == (0, 0, 1) and plain.dtype == torch.float64
    torch.testing.assert_close(fused, dense, rtol=0, atol=1e-4)
    torch.testing.assert_close(plain.float(), dense, rtol=0, atol=1e-4)
    one = filt.adjoint(a[:, :, 0], backend="bsr")
    assert one.shape == (500,) and cheb_bsr.launch_counts() == (0, 0, 2)
    torch.testing.assert_close(one, dense[:, 0], rtol=0, atol=1e-4)


def test_fista_panel_program_records_the_adjoint_kernel(cuda_device):
    from repro_torch.filters import CudaGraphProgram
    from repro_torch.solvers import LassoProblem, fista, lasso_panel_program

    filt, panels = _serve_setting(cuda_device)
    run = lasso_panel_program(filt, method="fista", mu=1.0, n_iters=8, backend="bsr")
    prog = CudaGraphProgram(run, cuda_device)
    cheb_bsr.reset_launch_counts()
    x, a, _ = (t.clone() for t in prog(panels[0]))
    # per replay: the initial forward apply, then one apply and one adjoint
    # per iteration, and the final adjoint
    assert prog.launches_per_replay == (9, 0, 9)
    assert cheb_bsr.launch_counts() == (18, 0, 18)  # the eager warm-up and one replay
    want = fista(LassoProblem(filt=filt, y=panels[0], mu=1.0), n_iters=8, backend="bsr")
    torch.testing.assert_close(x, want.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a, want.aux, rtol=1e-4, atol=1e-4)


def test_fista_on_bsr_matches_dense_at_the_deployment_shape(cuda_device):
    from repro_torch.solvers import LassoProblem, fista

    n = 8192
    scale = (500 / n) ** 0.5
    gen = torch.Generator().manual_seed(7)
    g = tgraph.random_sensor_graph(gen, n, 0.074 * scale, 0.075 * scale, device=cuda_device)
    lmax = float(g.lmax_bound())
    filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(lmax, 4), 20, graph=g, lmax=lmax)
    y = torch.randn(n, 256, generator=gen).to(cuda_device)
    problem = LassoProblem(filt=filt, y=y, mu=2.0)
    cheb_bsr.reset_launch_counts()
    got = fista(problem, n_iters=10, backend="bsr")
    assert cheb_bsr.launch_counts() == (11, 0, 11)
    want = fista(problem, n_iters=10, backend="dense")
    assert bool(torch.isfinite(got.x).all())
    torch.testing.assert_close(got.x, want.x, rtol=0, atol=2e-4)
    torch.testing.assert_close(got.aux, want.aux, rtol=0, atol=2e-4)


def test_bsr_backend_on_cuda_reaches_only_the_kernels(cuda_device):
    gen = torch.Generator().manual_seed(0)
    g = tgraph.connected_sensor_graph(gen, n=500, device=cuda_device)
    filt = GraphFilter.from_multipliers([tmult.tikhonov(1.0, 1)], 20, graph=g)
    y = torch.randn(500, 3, generator=gen).to(cuda_device)
    dense = filt.apply(y, backend="dense")
    cheb_bsr.reset_launch_counts()
    fused = filt.apply(y, backend="bsr")
    stepwise = filt.apply(y, backend="bsr", fuse=False)
    torch.cuda.synchronize()
    assert cheb_bsr.cheb_union_cuda.launches == 1
    assert cheb_bsr.cheb_step_cuda.launches == 20
    torch.testing.assert_close(fused, dense, rtol=0, atol=1e-4)
    torch.testing.assert_close(stepwise, dense, rtol=0, atol=1e-4)


def _solver_setting(device):
    from repro_torch import solvers

    gen = torch.Generator().manual_seed(1)
    g = tgraph.connected_sensor_graph(gen, n=96, sigma=0.17, kappa=0.18, device=device)
    lmax = float(g.lmax_bound())
    filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(lmax, 3), 16, graph=g, lmax=lmax)
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * torch.randn(f0.shape, generator=gen).to(device)
    return solvers, filt, y


def test_ista_on_the_kernels_matches_dense(cuda_device):
    solvers, filt, y = _solver_setting(cuda_device)
    problem = solvers.LassoProblem(filt=filt, y=y, mu=2.0)
    dense = solvers.ista(problem, n_iters=10, backend="dense")
    cheb_bsr.reset_launch_counts()
    fused = solvers.ista(problem, n_iters=10, backend="bsr")
    assert cheb_bsr.launch_counts() == (11, 0, 11)
    stepwise = solvers.ista(problem, n_iters=10, backend="bsr", fuse=False)
    # fuse= picks the apply's route; the adjoint's follows select_tiling
    assert cheb_bsr.launch_counts() == (11, 11 * 16, 22)
    for res in (fused, stepwise):
        torch.testing.assert_close(res.x, dense.x, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res.aux, dense.aux, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.history, dense.history, rtol=1e-4, atol=1e-4)


def test_cg_on_bsr_launches_one_union_per_gram(cuda_device):
    solvers, filt, y = _solver_setting(cuda_device)
    problem = solvers.GramProblem(filt=filt, b=y, reg=1.0)
    cheb_bsr.reset_launch_counts()
    res = solvers.conjugate_gradient(problem, n_iters=100, tol=1e-5, backend="bsr")
    assert res.converged and 0 < res.iterations < 100
    assert cheb_bsr.cheb_union_cuda.launches == res.iterations + 1
    assert cheb_bsr.cheb_step_cuda.launches == 0
    dense = solvers.conjugate_gradient(problem, n_iters=100, tol=1e-5, backend="dense")
    assert abs(dense.iterations - res.iterations) <= 1
    torch.testing.assert_close(res.x, dense.x, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("backend,opts", [("halo", {"overlap": True}), ("halo", {"overlap": False}),
                                          ("allgather", {})],
                         ids=["halo", "halo-serial", "allgather"])
def test_distributed_backends_on_cuda_match_dense(cuda_device, backend, opts):
    from repro_torch.core.collectives import StackedMesh

    solvers, filt, y = _solver_setting(cuda_device)
    mesh = StackedMesh(8, cuda_device)
    f = torch.stack([y, 2.0 * y], dim=1)
    got = filt.apply(f, backend=backend, mesh=mesh, **opts)
    kind = "all_to_all" if backend == "halo" else "all_gather"
    assert mesh.calls[kind] == filt.order and got.device.type == "cuda"
    torch.testing.assert_close(got, filt.apply(f, backend="dense"), rtol=1e-5, atol=1e-5)
    a = filt.apply(f, backend="dense")
    torch.testing.assert_close(filt.adjoint(a, backend=backend, mesh=mesh),
                               filt.adjoint(a, backend="dense"), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 2])
def test_grid_backend_on_cuda_matches_dense(cuda_device, depth):
    from repro_torch.core.collectives import StackedMesh

    g = tgraph.grid_graph(32, device=cuda_device)
    filt = GraphFilter.from_multipliers([tmult.tikhonov(1.0, 1), tmult.heat(0.5)], 12,
                                        graph=g, lmax=8.0)
    f = torch.randn(1024, 4, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    mesh = StackedMesh(8, cuda_device)
    got = filt.apply(f, backend="grid", mesh=mesh, depth=depth)
    assert mesh.calls["shift"] == 2 + 2 * -(-11 // depth)
    torch.testing.assert_close(got, filt.apply(f, backend="dense"), rtol=1e-5, atol=1e-5)
    a = filt.apply(f, backend="dense")
    torch.testing.assert_close(filt.adjoint(a, backend="grid", mesh=mesh, depth=depth),
                               filt.adjoint(a, backend="dense"), rtol=1e-5, atol=1e-5)


def _joint_setting(device, n_sensors=48, t=8):
    """A time-vertex product (sensor graph x path of ``t``) and a
    two-shift filter on it: a heat/Tikhonov bank at M = 8 on the sensor
    shift, heat at M = 5 on the time shift."""
    from repro_torch.core import chebyshev as tcheb

    gen = torch.Generator().manual_seed(4)
    gs = tgraph.connected_sensor_graph(gen, n=n_sensors, sigma=0.3, kappa=0.35, device=device)
    path = torch.diag(torch.ones(t - 1), 1) + torch.diag(torch.ones(t - 1), -1)
    coords = torch.cat([gs.coords.repeat_interleave(t, 0),
                        (torch.arange(t) / t).repeat(n_sensors)[:, None].to(device)], dim=1)
    shifts = [tgraph.SensorGraph(torch.kron(gs.adjacency, torch.eye(t, device=device)), coords),
              tgraph.SensorGraph(torch.kron(torch.eye(n_sensors, device=device), path.to(device)),
                                 coords)]
    lms = [float(s.lmax_bound()) for s in shifts]
    coeffs = tcheb.separable_joint_coefficients([
        tcheb.cheb_coefficients([tmult.heat(0.6), tmult.tikhonov(1.0, 1)], 8, lms[0]),
        tcheb.cheb_coefficients([tmult.heat(1.2)], 5, lms[1])])
    filt = GraphFilter.from_shifts(shifts, coeffs, lmaxes=lms)
    f = torch.randn(n_sensors * t, 3, generator=gen).to(device)
    return filt, f


def _on_cpu(filt):
    return GraphFilter.from_shifts(
        [tgraph.SensorGraph(s.adjacency.cpu(), s.coords.cpu()) for s in filt.shifts],
        filt.coeffs, lmaxes=filt.shift_lmaxes)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "stepwise"])
def test_joint_bsr_innermost_level_on_the_kernels_matches_plain(cuda_device, fuse):
    """The joint ``bsr`` apply and gram with the innermost level on the
    kernels (``prod_{s<R}(M_s+1)`` union launches per apply, or ``M_R``
    times that in steps) against the same joint apply on the CPU, whose
    innermost level is the kernels' plain version."""
    filt, f = _joint_setting(cuda_device)
    (m1, m2) = filt.orders
    cheb_bsr.reset_launch_counts()
    got = filt.apply(f, backend="bsr", fuse=fuse)
    torch.cuda.synchronize()
    want_launches = (m1 + 1, 0) if fuse else (0, m2 * (m1 + 1))
    assert (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches) == want_launches
    plain = _on_cpu(filt)
    torch.testing.assert_close(got.cpu(), plain.apply(f.cpu(), backend="bsr", fuse=fuse),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, filt.apply(f, backend="dense"), rtol=1e-5, atol=1e-5)
    cheb_bsr.reset_launch_counts()
    gram = filt.gram(f, backend="bsr", fuse=fuse)
    torch.cuda.synchronize()
    g1, g2 = (2 * m for m in filt.orders)
    assert (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches) == (
        (g1 + 1, 0) if fuse else (0, g2 * (g1 + 1)))
    torch.testing.assert_close(gram.cpu(), plain.gram(f.cpu(), backend="bsr", fuse=fuse),
                               rtol=1e-5, atol=1e-5)
    composed = filt.adjoint(filt.apply(f, backend="bsr", fuse=fuse), backend="bsr")
    torch.testing.assert_close(gram, composed, rtol=5e-4, atol=5e-4)


def test_union_kernel_takes_device_coefficients(cuda_device):
    g = tgraph.random_sensor_graph(torch.Generator().manual_seed(2), 256, 0.1, 0.11,
                                   device=cuda_device)
    bell = tref.bsr_from_dense(g.laplacian(), 8)
    f = torch.randn(256, 4, device=cuda_device)
    c = np.random.default_rng(0).standard_normal((2, 7)) / 4
    lmax = float(g.lmax_bound())
    host = cheb_bsr.cheb_union_cuda(bell.blocks, bell.cols, f, coeffs=c, lmax=lmax)
    dev = cheb_bsr.cheb_union_cuda(bell.blocks, bell.cols, f, coeffs=torch.as_tensor(c).to(
        cuda_device), lmax=lmax)
    torch.testing.assert_close(dev, host, rtol=0, atol=0)
    assert cheb_bsr.device_coeffs(c, f.device) is cheb_bsr.device_coeffs(c.copy(), f.device)
    with pytest.raises(ValueError, match="coeffs are on"):
        cheb_bsr.cheb_union_cuda(bell.blocks, bell.cols, f, coeffs=torch.as_tensor(c), lmax=lmax)


def test_joint_halo_on_cuda_matches_dense_without_kernels(cuda_device):
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.filters import shift_matvec_counts

    filt, f = _joint_setting(cuda_device)
    mesh = StackedMesh(8, cuda_device)
    cheb_bsr.reset_launch_counts()
    got = filt.apply(f, backend="halo", mesh=mesh)
    assert mesh.calls["all_to_all"] == sum(shift_matvec_counts(filt.orders))
    assert (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches) == (0, 0)
    torch.testing.assert_close(got, filt.apply(f, backend="dense"), rtol=1e-5, atol=1e-5)
    a = filt.apply(f, backend="dense")
    torch.testing.assert_close(filt.adjoint(a, backend="halo", mesh=mesh),
                               filt.adjoint(a, backend="dense"), rtol=1e-5, atol=1e-5)


# ---- the serving layer: one recorded CUDA graph per panel shape ------------


def _serve_setting(device, order=20):
    n = 500
    gen = torch.Generator().manual_seed(3)
    g = tgraph.connected_sensor_graph(gen, n=n, device=device)
    lmax = float(g.lmax_bound())
    filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(lmax, 4), order, graph=g, lmax=lmax)
    panels = [torch.randn(n, 16, generator=gen).to(device) for _ in range(3)]
    return filt, panels


@pytest.mark.parametrize("backend,opts,want", [("bsr", {}, (1, 0, 0)),
                                               ("bsr", {"fuse": False}, (0, 20, 0)),
                                               ("dense", {}, (0, 0, 0))],
                         ids=["bsr-fused", "bsr-stepwise", "dense"])
def test_panel_program_replays_match_eager_and_count_launches(cuda_device, backend, opts, want):
    from repro_torch.filters import CudaGraphProgram

    filt, panels = _serve_setting(cuda_device)
    prog = filt.panel_program(backend=backend, donate=True, **opts)
    assert isinstance(prog, CudaGraphProgram)
    cheb_bsr.reset_launch_counts()
    first = prog(panels[0]).clone()
    # the first call: one eager warm-up, then the capture (which launches
    # nothing) and one replay
    assert cheb_bsr.launch_counts() == tuple(2 * w for w in want)
    assert prog.launches_per_replay == want
    for p in panels[1:]:
        cheb_bsr.reset_launch_counts()
        got = prog(p)
        assert cheb_bsr.launch_counts() == want
        torch.testing.assert_close(got, filt.apply(p, backend=backend, **opts), rtol=0, atol=1e-6)
    torch.testing.assert_close(first, filt.apply(panels[0], backend=backend, **opts),
                               rtol=0, atol=1e-6)
    assert (prog.captures, prog.replays) == (1, 3)
    assert prog.graph is not None and prog.graph.raw_cuda_graph() != 0  # kept for inspection
    torch.testing.assert_close(first, filt.apply(panels[0], backend="dense"), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="recorded for"):
        prog(panels[0][:, :8].contiguous())
    with pytest.raises(ValueError, match="takes tensors on"):
        prog(panels[0].cpu())


def test_panel_program_memory_is_flat_and_donation_hands_back_the_static_output(cuda_device):
    filt, panels = _serve_setting(cuda_device)
    prog = filt.panel_program(backend="bsr", donate=True)
    out0 = prog(panels[0])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    seen = []
    for i in range(5):
        out = prog(panels[i % 3])
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_allocated(cuda_device))
        assert out.data_ptr() == out0.data_ptr()  # donated: the static output
    assert seen == [before] * 5
    own = filt.panel_program(backend="bsr", donate=False)
    a = own(panels[0])
    a_copy = a.clone()
    b = own(panels[1])
    assert a.data_ptr() != b.data_ptr()
    torch.testing.assert_close(a, a_copy, rtol=0, atol=0)  # not overwritten


def test_a_capture_that_fails_raises(cuda_device):
    from repro_torch.filters import CudaGraphProgram

    def syncs(x):
        return x * float(x.sum())  # reads the device inside the recorded region

    prog = CudaGraphProgram(syncs, cuda_device)
    before = (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches)
    with pytest.raises(RuntimeError):
        prog(torch.ones(8, 2, device=cuda_device))
    assert prog.captures == 0 and prog.graph is None
    assert (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches) == before
    torch.cuda.synchronize()  # the device is still usable
    with pytest.raises(ValueError, match="CUDA device"):
        CudaGraphProgram(syncs, "cpu")


def test_async_engine_records_apply_and_solve_programs(cuda_device):
    from repro_torch.serve import AsyncGraphFilterEngine, SchedulerConfig, lasso_panel_solver
    from repro_torch.solvers import LassoProblem, fista

    filt, _ = _serve_setting(cuda_device, order=12)
    rng = np.random.default_rng(0)
    sigs = rng.normal(size=(20, 500)).astype(np.float32)
    eng = AsyncGraphFilterEngine(
        filt, backend="bsr", solver=lasso_panel_solver(filt, n_iters=4),
        config=SchedulerConfig(max_panel=8, min_bucket=4), device=cuda_device)

    def workload(t0):
        cheb_bsr.reset_launch_counts()
        tks = [eng.submit(s, now=t0) for s in sigs[:11]]  # buckets 8 + 4
        tks += [eng.submit_solve(s, now=t0) for s in sigs[11:14]]  # bucket 4
        eng.drain(now=t0)
        assert all(t.done for t in tks)
        return tks, cheb_bsr.cheb_union_cuda.launches

    tks, _ = workload(0.0)
    assert eng.stats()["captures"] == 3 and eng.recompiles == 3
    tks, launches = workload(1.0)
    assert eng.recompiles == 3 and eng.stats()["captures"] == 3
    assert launches == 2 * 1 + 1 * (4 + 1)  # two apply panels, one FISTA-4 panel
    for tk, s in zip(tks[:11], sigs[:11]):
        assert tk.result.device.type == "cpu"
        torch.testing.assert_close(tk.result, filt.apply(torch.as_tensor(s).to(cuda_device),
                                                         backend="bsr").cpu(), rtol=0, atol=1e-5)
    for tk, s in zip(tks[11:], sigs[11:14]):
        want = fista(LassoProblem(filt=filt, y=torch.as_tensor(s).to(cuda_device), mu=1.0),
                     n_iters=4, backend="bsr")
        assert tk.result.x.device.type == "cpu" and tk.result.iterations == 4
        torch.testing.assert_close(tk.result.x, want.x.cpu(), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(tk.result.aux, want.aux.cpu(), rtol=1e-4, atol=1e-4)


def test_entry_points_default_to_the_current_card(cuda_device):
    from repro_torch.serve import AsyncGraphFilterEngine, GraphFilterEngine
    from repro_torch.stream import StreamingFilter

    filt, panels = _serve_setting(cuda_device, order=8)
    sig = panels[0][:, 0].cpu().numpy()
    for make in (GraphFilterEngine, AsyncGraphFilterEngine):
        assert make(filt).device == filt.graph.device
    (out,) = GraphFilterEngine(filt, panel_width=1).submit(sig)
    torch.testing.assert_close(out, filt.apply(panels[0][:, 0], backend="bsr").cpu(),
                               rtol=0, atol=1e-6)
    res = StreamingFilter(filt, backend="bsr").push(sig)
    assert res.out.device == filt.graph.device


def test_a_replay_survives_eviction_from_the_upload_cache(cuda_device):
    # A graph reads its coefficients by address. Once 64 other arrays
    # have gone through the upload cache, the coefficients' entry is
    # evicted; the program must still hold them, or the allocator hands
    # their block to the garbage below and a replay reads it.
    from repro_torch.device import cached_upload

    filt, panels = _serve_setting(cuda_device, order=17)  # coefficients no other test uploads
    # An eager apply uploads the coefficients on the current stream (a
    # program's warm-up would upload them on its side stream, whose
    # freed blocks the garbage below, made on this stream, never gets).
    filt.apply(panels[0], backend="bsr")
    progs = {"fused": (filt.panel_program(backend="bsr", donate=True), {}),
             "stepwise": (filt.panel_program(backend="bsr", donate=True, fuse=False),
                          {"fuse": False})}
    for prog, _ in progs.values():
        prog(panels[0])
    rng = np.random.default_rng(5)
    for _ in range(65):
        cached_upload(rng.normal(size=filt.coeffs.shape), cuda_device, torch.float32)
    garbage = [torch.full(filt.coeffs.shape, 1e3, device=cuda_device) for _ in range(512)]
    for name, (prog, opts) in progs.items():
        got = prog(panels[1]).clone()
        torch.testing.assert_close(got, filt.apply(panels[1], backend="bsr", **opts),
                                   rtol=0, atol=1e-6, msg=name)
    assert len(garbage) == 512


def test_ring_gossip_on_the_card_matches_the_cpu(cuda_device):
    # No kernel of its own: gossip is plain torch over the ring exchange.
    from repro_torch.core import gossip
    from repro_torch.core.collectives import StackedMesh

    gen = torch.Generator().manual_seed(2)
    tree = {"w": torch.randn(8, 64, 32, generator=gen), "b": torch.randn(8, 32, generator=gen)}
    before = cheb_bsr.launch_counts()
    for payload, tol in ((None, 1e-6), ("bfloat16", 1e-5)):
        cpu, card = StackedMesh(8, "cpu"), StackedMesh(8, cuda_device)
        want = gossip.chebyshev_gossip_mean(tree, cpu, order=12, payload_dtype=payload)
        got = {}
        words = gossip.measured_ppermute_words(card, lambda: got.update(gossip.chebyshev_gossip_mean(
            {k: v.to(cuda_device) for k, v in tree.items()}, card, order=12,
            payload_dtype=payload)))
        assert words == gossip.gossip_message_words(12, 8, 2080) // 8 // (2 if payload else 1)
        for k in tree:
            assert got[k].device.type == "cuda"
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=tol, atol=tol)
    assert cheb_bsr.launch_counts() == before


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    from repro_torch import checkpoint

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 7, generator=gen)
    tree = {"f32": x, "bf16": x.bfloat16(), "e4": x.to(torch.float8_e4m3fn),
            "e5": x.to(torch.float8_e5m2), "i": [torch.arange(6, dtype=torch.int32)]}
    tree = {k: ([t.to(cuda_device) for t in v] if isinstance(v, list) else v.to(cuda_device))
            for k, v in tree.items()}
    checkpoint.save(tmp_path, 2, tree)
    back = checkpoint.restore(tmp_path, 2, tree)
    for a, b in zip([tree["bf16"], tree["e4"], tree["e5"], tree["f32"], tree["i"][0]],
                    [back["bf16"], back["e4"], back["e5"], back["f32"], back["i"][0]]):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("arch", ["gemma2_2b", "deepseek_moe_16b", "xlstm_350m",
                                  "jamba15_large_398b", "internvl2_2b", "musicgen_medium"])
def test_lm_serving_on_the_card_matches_the_cpu(cuda_device, arch):
    # one smoke arch per family, f32: prefill + 3 greedy decode steps on
    # the card against the same weights on the CPU, and the card's greedy
    # engine ids against the CPU engine's
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_map

    cfg = registry.get_smoke(arch)
    par = ParallelConfig(attn_impl="naive", remat="none")
    params, _ = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    card = tree_map(lambda t: t.to(cuda_device), params)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    want, cache_w = lm.prefill(params, prompt, cfg, par, s_max=16)
    got, cache_g = lm.prefill(card, prompt.to(cuda_device), cfg, par, s_max=16)
    for _ in range(4):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        token = want[:, -1:].argmax(-1)
        assert torch.equal(got[:, -1:].argmax(-1).cpu(), token)
        want, cache_w = lm.decode_step(params, token, cache_w, cfg, par)
        got, cache_g = lm.decode_step(card, token.to(cuda_device), cache_g, cfg, par)
    assert cache_g["pos"].device.type == cuda_device.type and int(cache_g["pos"]) == 13
    prompts = prompt.numpy().astype(np.int32)
    np.testing.assert_array_equal(
        ServeEngine(cfg=cfg, par=par, params=card, s_max=24, device=cuda_device).generate(
            prompts, max_new_tokens=6),
        ServeEngine(cfg=cfg, par=par, params=params, s_max=24, device="cpu").generate(
            prompts, max_new_tokens=6))


def _smoke_train(arch, device):
    from repro_torch.configs import registry
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = registry.get_smoke(arch)
    params, _ = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = SyntheticTokenPipeline(cfg.vocab_size, 16, 8, device="cpu").batch_at(0)
    return cfg, params, tree_map(lambda t: t.to(device), params), batch


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda_device):
    # loss and grads within the CPU parity tests' tolerances, and one
    # donated train step's params within 2 lr (AdamW's step-1 sign trap)
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelConfig
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg, params, card, batch = _smoke_train("gemma2_2b", cuda_device)
    par = ParallelConfig(attn_impl="chunked", attn_chunk=8, remat="block", microbatches=2)
    card_batch = tree_map(lambda t: t.to(cuda_device), batch)

    def loss_fn(p, b):
        return lm.loss_fn(p, b, cfg, par)

    l_cpu, _, g_cpu = value_and_grad(loss_fn, params, batch)
    l_card, _, g_card = value_and_grad(loss_fn, card, card_batch)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        assert a.device.type == cuda_device.type
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5 + 1e-4 * float(b.abs().max()))
    optc = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, par, optc)
    want, _, _ = step(params, init_opt_state(params, optc), batch)
    got, _, m = step(card, init_opt_state(card, optc), card_batch, donate=True)
    assert m["loss"].device.type == cuda_device.type
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-3 + 1e-6)


def test_donated_train_step_keeps_memory_flat(cuda_device):
    from repro_torch.launch.donation import jit_train_step
    from repro_torch.models.config import ParallelConfig
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg, _, card, batch = _smoke_train("llama3_405b", cuda_device)
    batch = tree_map(lambda t: t.to(cuda_device), batch)
    optc = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = jit_train_step(make_train_step(cfg, ParallelConfig(attn_impl="naive", remat="block",
                                                              microbatches=2), optc))
    opt = init_opt_state(card, optc)
    ptrs = [t.data_ptr() for t in tree_leaves((card, opt))]
    mem = []
    for _ in range(5):
        card, opt, m = step(card, opt, batch)
        float(m["loss"])
        mem.append(torch.cuda.memory_allocated(cuda_device))
    assert [t.data_ptr() for t in tree_leaves((card, opt))] == ptrs
    assert max(mem[1:]) == min(mem[1:]), mem


def test_gossip_train_step_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.launch.donation import jit_train_step
    from repro_torch.models.config import ParallelConfig
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_gossip_train_step, replicate
    from repro_torch.tree import tree_map

    cfg, params, card, batch = _smoke_train("codeqwen15_7b", cuda_device)
    optc = AdamWConfig(peak_lr=4e-3, warmup_steps=2, total_steps=40)
    par = ParallelConfig(attn_impl="naive", remat="none", grad_sync="gossip", gossip_order=6,
                         gossip_buckets=4, gossip_overlap=True, microbatches=2)
    losses = {}
    for dev, p in (("cpu", params), (cuda_device, card)):
        step = jit_train_step(make_gossip_train_step(cfg, par, optc, None, StackedMesh(4, dev)))
        p, o = replicate(p, 4), replicate(init_opt_state(p, optc), 4)
        b = tree_map(lambda t: t.to(dev), batch)
        losses[str(dev)] = [float(step(p, o, b)[2]["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"], rtol=0, atol=1e-5)


def test_dry_run_hardware_fits_the_card_and_counts_as_the_flop_counter(cuda_device):
    # The dry run's H100 model holds no more memory than this card has,
    # and analyze_step counts a one-layer train step's matmul FLOPs on the
    # card as torch's own FlopCounterMode counts the same step.
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.op_costs import analyze_step
    from repro_torch.launch.roofline import HW
    from repro_torch.models.config import ParallelConfig
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    assert HW.hbm_capacity <= torch.cuda.get_device_properties(cuda_device).total_memory
    cfg, _, params, batch = _one_layer_train(cuda_device)
    optc = AdamWConfig()
    step = make_train_step(cfg, ParallelConfig(attn_impl="naive", remat="block"), optc)
    got = analyze_step(step, params, init_opt_state(params, optc), batch)
    counter = FlopCounterMode(display=False)
    with counter:
        step(params, init_opt_state(params, optc), batch)
    assert got.matmul_flops == counter.get_total_flops() > 0


def _one_layer_train(device):
    """Gemma-2's smoke config cut to one repeat group, params and a batch
    on ``device``."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = registry.get_smoke("gemma2_2b")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    params, _ = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = SyntheticTokenPipeline(cfg.vocab_size, 16, 4, device="cpu").batch_at(0)
    return cfg, params, tree_map(lambda t: t.to(device), params), \
        tree_map(lambda t: t.to(device), batch)
