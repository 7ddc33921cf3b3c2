"""Port parity for ``repro_torch.kernels``: the plain versions of the two
Block-ELL kernels against the reference Pallas kernels in interpret mode,
the plain version of the fused adjoint against the plain eq. 13
recurrence, the ops chains, the wrappers' CPU path and the Hopper tiling
decision."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import multipliers as jmult
from repro.kernels import ref as jref
from repro.kernels.cheb_bsr import cheb_step_pallas, cheb_union_pallas
from repro_torch import interop
from repro_torch.core import chebyshev as tcheb
from repro_torch.core import graph as tgraph
from repro_torch.kernels import autotune, cheb_bsr, ops
from repro_torch.kernels import ref as tref

BF16_REL_BOUND = 16 * 2.0**-8  # tests/test_krylov_precision.py


def _random_operands(n_rows, k_max, block, f, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    blocks = (scale * rs.randn(n_rows, k_max, block, block)).astype(np.float32)
    cols = np.stack(
        [np.random.RandomState(i).choice(n_rows, size=k_max, replace=False) for i in range(n_rows)]
    ).astype(np.int32)
    t1 = rs.randn(n_rows * block, f).astype(np.float32)
    t2 = rs.randn(n_rows * block, f).astype(np.float32)
    return blocks, cols, t1, t2


def _both(x, dtype):
    """The same values in JAX and torch, rounded once to ``dtype``."""
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.as_tensor(xb.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.as_tensor(x)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


@pytest.mark.parametrize("block,f,ftile", [(8, 8, 8), (8, 32, 16), (16, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("first", [False, True])
def test_cheb_step_ref_matches_pallas(block, f, ftile, dtype, first):
    blocks, cols, t1, t2 = _random_operands(6, 3, block, f)
    bj, bt = _both(blocks, dtype)
    t1j, t1t = _both(t1, dtype)
    t2j, t2t = _both(t2, dtype)
    alpha = 3.7
    want = cheb_step_pallas(
        bj, jnp.asarray(cols), t1j, t2j, alpha=alpha, first=first, f_tile=ftile, interpret=True
    )
    got = tref.cheb_step_ref(bt, torch.as_tensor(cols), t1t, t2t, alpha, first=first)
    assert got.dtype == t1t.dtype
    # Through the wrapper: a CPU tensor takes the plain version, uncounted.
    before = cheb_bsr.cheb_step_cuda.launches
    wrapped = cheb_bsr.cheb_step_cuda(
        bt, torch.as_tensor(cols), t1t, t2t, alpha=alpha, first=first, f_tile=ftile
    )
    assert cheb_bsr.cheb_step_cuda.launches == before
    assert torch.equal(wrapped, got)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=tol, atol=tol)


def _laplacian_operands(n=96, block=8, seed=0):
    import jax

    from repro.core import graph as jgraph

    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(seed), n=n, sigma=0.17, kappa=0.18)
    lap = np.asarray(g.laplacian())
    order = jgraph.spatial_partition_order(np.asarray(g.coords), max(n // block, 1))
    bell = jref.bsr_from_dense(lap[np.ix_(order, order)], block)
    return bell, float(g.lmax_bound())


@pytest.fixture(scope="module")
def lap_operands():
    return _laplacian_operands()


@pytest.mark.parametrize("order,f", [(1, 4), (2, 1), (7, 8)])
def test_cheb_union_ref_matches_pallas_f32(lap_operands, order, f):
    bell, lmax = lap_operands
    coeffs = jcheb.cheb_coefficients([jmult.heat(0.6), jmult.tikhonov(1.0, 1)], order, lmax)
    x = np.random.RandomState(order).randn(bell.n, f).astype(np.float32)
    ctup = tuple(tuple(float(v) for v in row) for row in coeffs)
    want = cheb_union_pallas(
        bell.blocks, bell.cols, jnp.asarray(x), coeffs=ctup, lmax=lmax, interpret=True
    )
    tb = interop.block_ell_from_numpy(np.asarray(bell.blocks), np.asarray(bell.cols), device="cpu")
    got = tref.cheb_union_ref(tb.blocks, tb.cols, torch.as_tensor(x), coeffs, lmax)
    assert got.shape == (2, bell.n, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # The wrapper on CPU tensors is the plain version, uncounted.
    before = cheb_bsr.cheb_union_cuda.launches
    wrapped = cheb_bsr.cheb_union_cuda(
        tb.blocks, tb.cols, torch.as_tensor(x), coeffs=coeffs, lmax=lmax
    )
    assert cheb_bsr.cheb_union_cuda.launches == before
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("order", [6])
def test_cheb_union_ref_bf16_krylov_within_bound(lap_operands, order):
    bell, lmax = lap_operands
    coeffs = jcheb.cheb_coefficients([jmult.heat(0.5), jmult.tikhonov(1.0, 1)], order, lmax)
    x = np.random.RandomState(4).randn(bell.n, 8).astype(np.float32)
    ctup = tuple(tuple(float(v) for v in row) for row in coeffs)
    want_f32 = np.asarray(jref.cheb_apply_bsr_ref(bell, jnp.asarray(x), coeffs, lmax))
    want_bf16 = np.asarray(cheb_union_pallas(
        bell.blocks, bell.cols, jnp.asarray(x), coeffs=ctup, lmax=lmax, interpret=True,
        krylov_dtype="bfloat16",
    ))
    tb = interop.block_ell_from_numpy(np.asarray(bell.blocks), np.asarray(bell.cols), device="cpu")
    got = tref.cheb_union_ref(
        tb.blocks, tb.cols, torch.as_tensor(x), coeffs, lmax, krylov_dtype=torch.bfloat16
    ).numpy()
    assert got.dtype == np.float32  # accumulators and output stay f32
    scale = np.max(np.abs(want_f32))
    assert np.max(np.abs(got - want_f32)) / scale < BF16_REL_BOUND
    assert np.max(np.abs(got - want_bf16)) / scale < BF16_REL_BOUND


@pytest.mark.parametrize("order", [5, 20])
def test_cheb_union_ref_default_is_explicit_f32(lap_operands, order):
    bell, lmax = lap_operands
    coeffs = jcheb.cheb_coefficients([jmult.heat(0.5)], order, lmax)
    x = torch.as_tensor(np.random.RandomState(5).randn(bell.n, 8).astype(np.float32))
    tb = interop.block_ell_from_numpy(np.asarray(bell.blocks), np.asarray(bell.cols), device="cpu")
    default = tref.cheb_union_ref(tb.blocks, tb.cols, x, coeffs, lmax)
    explicit = tref.cheb_union_ref(tb.blocks, tb.cols, x, coeffs, lmax, krylov_dtype=torch.float32)
    assert default.numpy().tobytes() == explicit.numpy().tobytes()
    fused = ops.cheb_apply_bsr_fused(tb.blocks, tb.cols, x, coeffs, lmax)
    fused_f32 = ops.cheb_apply_bsr_fused(tb.blocks, tb.cols, x, coeffs, lmax,
                                         krylov_dtype=torch.float32)
    assert fused.numpy().tobytes() == fused_f32.numpy().tobytes()


@pytest.mark.parametrize("krylov", [None, "bfloat16"])
def test_stepwise_chain_matches_reference(lap_operands, krylov):
    bell, lmax = lap_operands
    coeffs = jcheb.cheb_coefficients([jmult.heat(0.6), jmult.tikhonov(1.0, 1)], 12, lmax)
    x = np.random.RandomState(6).randn(bell.n, 8).astype(np.float32)
    want = np.asarray(jref.cheb_apply_bsr_ref(bell, jnp.asarray(x), coeffs, lmax))
    tb = interop.block_ell_from_numpy(np.asarray(bell.blocks), np.asarray(bell.cols), device="cpu")
    kd = torch.bfloat16 if krylov else None
    got = ops.cheb_apply_bsr(tb.blocks, tb.cols, torch.as_tensor(x), coeffs, lmax,
                             krylov_dtype=kd).numpy()
    if krylov:
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < BF16_REL_BOUND
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    plain = tref.cheb_apply_bsr_ref(tb, torch.as_tensor(x), coeffs, lmax).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)
    fused = ops.cheb_apply_bsr_fused(tb.blocks, tb.cols, torch.as_tensor(x), coeffs, lmax)
    np.testing.assert_allclose(fused.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def port_laplacian():
    """A 256-node sensor graph's Laplacian and its lambda-max bound."""
    g = tgraph.random_sensor_graph(torch.Generator().manual_seed(0), 256, 0.1, 0.11, device="cpu")
    return g.laplacian(), float(g.lmax_bound())


@pytest.mark.parametrize("f", [1, 100])
@pytest.mark.parametrize("order", [1, 2, 20])
@pytest.mark.parametrize("eta", [1, 5, 10])
@pytest.mark.parametrize("block", [8, 16])
def test_cheb_adjoint_union_ref_matches_plain_recurrence(port_laplacian, block, eta, order, f):
    """Clenshaw's transposed sweep against eq. 13's recurrence on
    eta-stacked columns over the plain Block-ELL matvec, both in f32."""
    lap, lmax = port_laplacian
    bell = tref.bsr_from_dense(lap, block)
    coeffs = np.random.RandomState(order).randn(eta, order + 1) / (1 + np.arange(order + 1))
    a = torch.randn(eta, bell.n, f, generator=torch.Generator().manual_seed(eta))
    got = tref.cheb_adjoint_union_ref(bell.blocks, bell.cols, a, coeffs, lmax)
    want = tcheb.cheb_adjoint_apply(
        lambda v: tref.bsr_matvec_ref(bell, v.reshape(bell.n, -1)).reshape(v.shape), a,
        coeffs, lmax)
    assert got.shape == (bell.n, f) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # The wrapper on CPU tensors is the plain version, uncounted; an
    # (eta, N) input gives an (N,) output.
    before = cheb_bsr.cheb_adjoint_union_cuda.launches
    wrapped = cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a, coeffs=coeffs, lmax=lmax)
    assert cheb_bsr.cheb_adjoint_union_cuda.launches == before
    assert torch.equal(wrapped, got)
    if f == 1:
        flat = cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a[:, :, 0],
                                                coeffs=coeffs, lmax=lmax)
        assert flat.shape == (bell.n,) and torch.equal(flat, got[:, 0])


def test_cheb_adjoint_union_ref_is_the_adjoint_in_float64(port_laplacian):
    """<Phi~ f, a> = <f, Phi~* a> on a small Block-ELL graph, float64."""
    lap, lmax = port_laplacian
    bell = tref.bsr_from_dense(lap.double(), 8, dtype=torch.float64)
    dense = tref.bsr_to_dense(bell)
    gen = torch.Generator().manual_seed(3)
    coeffs = np.random.RandomState(3).randn(4, 13)
    f = torch.randn(bell.n, 6, generator=gen, dtype=torch.float64)
    a = torch.randn(4, bell.n, 6, generator=gen, dtype=torch.float64)
    fwd = tcheb.cheb_apply(lambda v: dense @ v, f, coeffs, lmax)
    back = tref.cheb_adjoint_union_ref(bell.blocks, bell.cols, a, coeffs, lmax)
    assert back.dtype == torch.float64
    lhs, rhs = float(torch.sum(fwd * a)), float(torch.sum(f * back))
    assert abs(lhs - rhs) <= 1e-12 * float(fwd.abs().sum() * a.abs().max())


def test_adjoint_wrapper_checks_operands(port_laplacian):
    lap, lmax = port_laplacian
    bell = tref.bsr_from_dense(lap, 8)
    a = torch.randn(2, bell.n, 3)
    with pytest.raises(ValueError, match="order 1"):
        cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a, coeffs=[[1.0], [1.0]],
                                         lmax=lmax)
    with pytest.raises(ValueError, match="3 blocks"):
        cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, torch.randn(3, bell.n, 3),
                                         coeffs=np.ones((2, 4)), lmax=lmax)
    with pytest.raises(ValueError, match="N ="):
        cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a[:, :8],
                                         coeffs=np.ones((2, 4)), lmax=lmax)
    with pytest.raises(ValueError, match="eta, N"):
        cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, a[0, :, 0],
                                         coeffs=np.ones((1, 4)), lmax=lmax)


def test_bsr_matvec_ref_matches_reference(lap_operands):
    bell, _ = lap_operands
    x = np.random.RandomState(7).randn(bell.n, 3).astype(np.float32)
    want = np.asarray(jref.bsr_matvec_ref(bell, jnp.asarray(x)))
    tb = interop.block_ell_from_numpy(np.asarray(bell.blocks), np.asarray(bell.cols), device="cpu")
    np.testing.assert_allclose(
        tref.bsr_matvec_ref(tb, torch.as_tensor(x)).numpy(), want, rtol=1e-6, atol=1e-6
    )


def test_block_ell_rejects_out_of_range_columns():
    blocks = torch.zeros(3, 2, 8, 8)
    with pytest.raises(ValueError, match="block columns"):
        tref.BlockEll(blocks, torch.tensor([[0, 1], [2, 3], [0, 0]], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tref.BlockEll(blocks, torch.zeros(3, 2, dtype=torch.int64))


def test_wrappers_check_operands():
    blocks, cols, t1, t2 = (torch.as_tensor(a) for a in _random_operands(4, 2, 8, 4))
    with pytest.raises(ValueError, match="N ="):
        cheb_bsr.cheb_step_cuda(blocks, cols, t1[:8], t2[:8], alpha=2.0)
    with pytest.raises(TypeError, match="t2 dtype"):
        cheb_bsr.cheb_step_cuda(blocks, cols, t1, t2.double(), alpha=2.0)
    with pytest.raises(ValueError, match="order 1"):
        cheb_bsr.cheb_union_cuda(blocks, cols, t1, coeffs=[[1.0]], lmax=4.0)


@pytest.mark.parametrize("n,f,refused", [(2**20, 2**11 - 1, False), (2**20, 2**11, True),
                                         (8, 2**28, True)])
def test_kernels_refuse_signals_past_32_bit_indices(n, f, refused):
    if refused:
        with pytest.raises(ValueError, match="2\\*\\*31"):
            cheb_bsr._check_index_range(n, f)
    else:
        cheb_bsr._check_index_range(n, f)


# ---- the Hopper tiling decision ------------------------------------------

THREADS = 132 * 512  # H100 SXM: 132 SMs x 512 resident threads, 8 rows of a column each


def test_select_tiling_fuses_while_one_column_fits_the_resident_grid():
    """The docstring's rule: fuse iff the signal is f32, B is 8 or 16 and
    N / 8 <= sm_count * 512; f_tile is the columns one pass holds, rounded
    down to a multiple of 32 when the pass does not hold all of F."""
    assert autotune.union_resident_threads() == THREADS
    t = autotune.select_tiling(8192, 256, 5, 1024, 10, 8)
    assert t.fuse and THREADS // 1024 == 66 and t.f_tile == 64
    assert t.pass_bytes <= autotune.L2_BUDGET_BYTES
    t = autotune.select_tiling(8192, 1, 5, 1024, 10, 8)
    assert t.fuse and t.f_tile == 1
    # One pass holds all of F: no rounding.
    t = autotune.select_tiling(8192, 40, 5, 1024, 10, 8)
    assert t.fuse and t.f_tile == 40
    t = autotune.select_tiling(504, 1, 1, 63, 12, 8)
    assert t.fuse and t.f_tile == 1
    # B = 16: two threads a strip, so the same 1024 threads a column.
    t = autotune.select_tiling(8192, 256, 5, 512, 10, 16)
    assert t.fuse and t.f_tile == 64
    t = autotune.select_tiling(8192, 256, 5, 1024, 10, 8, torch.bfloat16)
    assert not t.fuse and t.f_tile == autotune.STEP_F_TILE
    # A smaller card holds less: the decision follows its SM count.
    t = autotune.select_tiling(8192, 256, 5, 1024, 10, 8, sm_count=114)
    assert t.fuse and 114 * 512 // 1024 == 57 and t.f_tile == 32


@pytest.mark.parametrize(
    "n_rows,block,fuse",
    [(THREADS, 8, True), (THREADS + 1, 8, False), (THREADS // 2, 16, True),
     (THREADS // 2 + 1, 16, False), (64, 32, False), (64, 4, False)],
    ids=["b8-full", "b8-over", "b16-full", "b16-over", "b32", "b4"],
)
def test_select_tiling_fuses_only_what_the_kernel_holds(n_rows, block, fuse):
    """Past the resident grid, or at a B the kernel is not built for, the
    apply takes the stepwise chain with the step kernel's slab."""
    t = autotune.select_tiling(n_rows * block, 4, 1, n_rows, 4, block)
    assert t.fuse == fuse
    assert t.f_tile == (1 if fuse else 4)


@pytest.mark.parametrize(
    "f,f_tile,eta,order,block,want",
    [(256, 64, 5, 20, 8, 4 * 19), (1, 1, 1, 20, 8, 19), (100, 32, 10, 20, 16, 3 * 4 * 19 + 2),
     (40, 64, 9, 1, 8, 1)],
    ids=["deploy", "paper", "ragged-b16", "order1"],
)
def test_union_grid_barriers(f, f_tile, eta, order, block, want):
    """M - 1 barriers per pass and multiplier group, one between groups."""
    assert autotune.union_grid_barriers(f, f_tile, eta, order, block) == want


def test_select_tiling_adjoint_adds_its_eta_input_columns():
    """The adjoint reads the eta input columns of its pass at every order:
    the same fuse rule, and at the lasso shape the forward's 4 passes of
    64, with eta * N * 4 more bytes a column in the pass."""
    fwd = autotune.select_tiling(8192, 256, 5, 1024, 10, 8)
    adj = autotune.select_tiling(8192, 256, 5, 1024, 10, 8, adjoint=True)
    assert adj.fuse and adj.f_tile == fwd.f_tile == 64
    assert adj.pass_bytes - fwd.pass_bytes == 4 * 8192 * 64 * 4
    assert adj.pass_bytes <= autotune.L2_BUDGET_BYTES
    # Many multipliers: the L2 budget, not the resident grid, sets the pass.
    wide = autotune.select_tiling(8192, 256, 60, 1024, 10, 8, adjoint=True)
    assert wide.fuse and wide.f_tile == 19 and wide.pass_bytes <= autotune.L2_BUDGET_BYTES
    for kw in ({}, {"adjoint": True}):
        assert not autotune.select_tiling(8192, 256, 5, 1024, 10, 8, torch.bfloat16, **kw).fuse


def test_select_tiling_l2_budget_limits_the_pass():
    # Tiles alone near the budget leave room for a narrow pass only.
    n, n_rows, block = 4096, 512, 8
    k_max = (autotune.L2_BUDGET_BYTES - 10 * n * 12) // (n_rows * (block * block * 4 + 4))
    t = autotune.select_tiling(n, 64, 1, n_rows, k_max, block)
    assert t.fuse and 1 <= t.f_tile < 64
    assert t.pass_bytes <= autotune.L2_BUDGET_BYTES


def test_f_tile_table_starts_empty():
    assert autotune._F_TILE_TABLE == {}


def test_parse_ptxas_report_reads_registers_and_spills():
    from repro_torch.kernels._build import parse_ptxas_report

    union = "_ZN12_GLOBAL__N_117cheb_union_kernelILi8EfEEvPKfPKiS3_S3_PT0_S6_Pfiiiiiiff"
    text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{union}' for 'sm_90a'",
        f"ptxas info    : Function properties for {union}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 436 bytes cmem[0]",
    ])
    assert parse_ptxas_report(text) == {
        union: {"registers": 128, "spill_stores": 8, "spill_loads": 4}
    }
    assert parse_ptxas_report("") == {}
