"""Port parity for ``repro_torch.filters`` and ``repro_torch.apps``:
``GraphFilter`` on the dense, bsr (fused and stepwise) and matvec
backends, and the paper's denoising slice, held against the JAX package
on the reference's own graphs passed through ``repro_torch.interop``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import denoising as japps
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.filters import GraphFilter as JFilter
from repro_torch import interop
from repro_torch.apps import denoising as tapps
from repro_torch.core import multipliers as tmult
from repro_torch.filters import (
    GraphFilter,
    available_backends,
    bucket_size,
    get_backend,
    require_capability,
    shift_matvec_counts,
)

ORDER = 8


@pytest.fixture(scope="module")
def small():
    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(0), n=96, sigma=0.17, kappa=0.18)
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), np.asarray(g.coords), "cpu")
    jf = JFilter.from_multipliers([jmult.heat(0.6), jmult.tikhonov(1.0, 1)], ORDER, graph=g)
    tf = interop.filter_from_numpy(jf.coeffs, jf.lmax, tg)
    f = np.random.RandomState(0).randn(96, 4).astype(np.float32)
    return g, tg, jf, tf, f


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_filter_from_multipliers_matches_reference(small):
    g, tg, jf, _, _ = small
    tf = GraphFilter.from_multipliers([tmult.heat(0.6), tmult.tikhonov(1.0, 1)], ORDER, graph=tg)
    assert abs(tf.lmax - jf.lmax) <= 1e-6 * jf.lmax
    np.testing.assert_allclose(tf.coeffs, jf.coeffs, rtol=1e-5, atol=1e-7)
    assert tf.eta == 2 and tf.order == ORDER and tf.n_shifts == 1
    assert abs(tf.operator_norm_bound() - jf.operator_norm_bound()) < 1e-5


@pytest.mark.parametrize(
    "backend,opts",
    [("dense", {}), ("bsr", {"fuse": True}), ("bsr", {"fuse": False}),
     ("bsr", {"block_size": 16})],
    ids=["dense", "bsr-fused", "bsr-stepwise", "bsr-b16"],
)
@pytest.mark.parametrize("squeeze", [False, True], ids=["2d", "1d"])
def test_apply_adjoint_gram_match_reference(small, backend, opts, squeeze):
    _, _, jf, tf, f = small
    x = f[:, 0] if squeeze else f
    want = jf.apply(jnp.asarray(x), backend="dense")
    got = tf.apply(torch.as_tensor(x), backend=backend, **opts)
    assert got.shape == (2,) + x.shape and got.dtype == torch.float32
    _close(got, want)
    a = np.asarray(want)
    _close(tf.adjoint(torch.as_tensor(a), backend=backend, **opts),
           jf.adjoint(jnp.asarray(a), backend="dense"))
    _close(tf.gram(torch.as_tensor(x), backend=backend, **opts),
           jf.gram(jnp.asarray(x), backend="dense"))


@pytest.mark.parametrize("opts,dtype,fused", [({}, np.float32, True),
                                              ({"fuse": False}, np.float32, True),
                                              ({"block_size": 16}, np.float32, True),
                                              ({"block_size": 4}, np.float32, False),
                                              ({}, np.float64, False)],
                         ids=["default", "fuse-false", "b16", "b4", "float64"])
@pytest.mark.parametrize("squeeze", [False, True], ids=["2d", "1d"])
def test_bsr_adjoint_takes_the_fused_kernel_where_the_tiling_fuses(small, monkeypatch, opts,
                                                                  dtype, fused, squeeze):
    """A single-shift bsr adjoint calls the fused adjoint wrapper (its plain
    version on the CPU) where select_tiling fuses, whatever the apply's
    ``fuse=`` says, and the plain recurrence otherwise (a block size the
    kernel is not built for, a float64 signal); both agree with the
    reference's dense adjoint. The backend hands the wrapper the f_tile
    of its own tiling decision."""
    from repro_torch.kernels import cheb_bsr

    _, _, jf, tf, f = small
    calls = []
    wrapper = cheb_bsr.cheb_adjoint_union_cuda

    def spy(*args, **kw):
        calls.append((args[2].shape, kw.get("f_tile")))
        return wrapper(*args, **kw)

    monkeypatch.setattr(cheb_bsr, "cheb_adjoint_union_cuda", spy)
    x = f[:, 0] if squeeze else f
    a = np.asarray(jf.apply(jnp.asarray(x), backend="dense"))
    got = tf.adjoint(torch.as_tensor(a.astype(dtype)), backend="bsr", **opts)
    assert got.shape == x.shape and got.dtype == torch.as_tensor(a.astype(dtype)).dtype
    _close(got, jf.adjoint(jnp.asarray(a), backend="dense"))
    n_pad = -(-96 // opts.get("block_size", 8)) * opts.get("block_size", 8)
    f_cols = x.shape[1] if x.ndim == 2 else 1
    assert calls == ([((2, n_pad, f_cols), f_cols)] if fused else [])


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "stepwise"])
def test_bsr_matches_reference_bsr(small, fuse):
    """Port bsr (plain kernel versions) == reference bsr (Pallas in
    interpret mode) on the same filter and signal."""
    _, _, jf, tf, f = small
    _close(tf.apply(torch.as_tensor(f), backend="bsr", fuse=fuse),
           jf.apply(jnp.asarray(f), backend="bsr", fuse=fuse))


def test_matvec_backend_matches_reference(small):
    g, tg, jf, tf, f = small
    lap_j, lap_t = g.laplacian(), tg.laplacian()
    want = jf.apply(jnp.asarray(f), backend="matvec", matvec=lambda v: lap_j @ v)
    _close(tf.apply(torch.as_tensor(f), backend="matvec", matvec=lambda v: lap_t @ v), want)
    a = np.asarray(want)
    _close(
        tf.adjoint(torch.as_tensor(a), backend="matvec",
                   matvec=lambda v: torch.tensordot(lap_t, v, dims=1)),
        jf.adjoint(jnp.asarray(a), backend="matvec",
                   matvec=lambda v: jnp.tensordot(lap_j, v, axes=1)),
    )
    with pytest.raises(ValueError, match="matvec="):
        tf.apply(torch.as_tensor(f), backend="matvec")


def test_apply_panel_and_series(small):
    _, _, jf, tf, f = small
    x = torch.as_tensor(f[:, :3])
    full = tf.apply(x, backend="bsr")
    panel = tf.apply_panel(x, backend="bsr")
    assert panel.shape == full.shape
    torch.testing.assert_close(panel, full, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="narrower"):
        tf.apply_panel(x, width=2)
    series = np.array([1.0, 0.5, 0.25])
    _close(tf.apply_series(x, series, backend="bsr"),
           jf.apply_series(jnp.asarray(f[:, :3]), series, backend="dense"))


def test_numpy_signal_goes_to_graph_device(small):
    _, _, _, tf, f = small
    out = tf.apply(f, backend="dense")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_registry_and_capabilities(small):
    from repro.filters import available_backends as javailable

    _, _, _, tf, _ = small
    # the reference's registry: the distributed backends came with their slice
    assert available_backends() == javailable() == (
        "allgather", "bsr", "dense", "grid", "halo", "matvec")
    with pytest.raises(KeyError, match="available"):
        get_backend("nope")
    for name in available_backends():
        caps = get_backend(name).capabilities
        # the restricted delta apply runs on dense only, as in the reference
        assert caps.sparse_input == (name == "dense")
        # multi-shift joint filters run on dense, bsr and halo, as in the reference
        assert caps.multi_shift == (name in ("bsr", "dense", "halo"))
        if caps.multi_shift:
            require_capability(name, "multi_shift")
        else:
            with pytest.raises(ValueError, match=rf"'{name}'.*'multi_shift'.*\['bsr', 'dense', 'halo'\]"):
                require_capability(name, "multi_shift")
    with pytest.raises(AttributeError, match="unknown capability"):
        require_capability("dense", "teleport")
    # one shift through from_shifts is a single-shift filter
    one = GraphFilter.from_shifts([tf.graph], tf.coeffs, lmaxes=[tf.lmax])
    assert one.n_shifts == 1 and one.order == ORDER and one.shift_lmaxes == (tf.lmax,)
    np.testing.assert_allclose(one.gram_coeffs, tf.gram_coeffs, rtol=0, atol=1e-12)
    for backend in ("bsr", "dense", "matvec"):  # single-device: no network words
        opts = {"matvec": lambda v: v} if backend == "matvec" else {}
        assert tf.messages_per_apply(backend=backend, **opts) == 0


def test_bucket_and_matvec_counts_match_reference():
    from repro.filters import bucket_size as jbucket, shift_matvec_counts as jcounts

    for n, cap in [(0, None), (5, None), (33, None), (100, 64), (70, 96), (3, 2)]:
        assert bucket_size(n, cap) == jbucket(n, cap)
    assert bucket_size(9, floor=8) == jbucket(9, floor=8) == 16
    assert shift_matvec_counts([20]) == jcounts([20]) == (20,)
    assert shift_matvec_counts([3, 4]) == jcounts([3, 4])


def test_bind_resets_prepared_state(small):
    _, tg, _, tf, f = small
    tf.apply(torch.as_tensor(f), backend="bsr")
    assert tf._states
    rebound = tf.bind(tg)
    assert rebound._states == {} and rebound.graph is tg


# ---- the slice as a whole: the paper's Sec. V-B experiment ---------------


@pytest.fixture(scope="module")
def paper():
    key = jax.random.PRNGKey(0)
    g = jgraph.connected_sensor_graph(key, n=500)
    coords = np.asarray(g.coords)
    f0 = coords[:, 0] ** 2 + coords[:, 1] ** 2 - 1.0
    y = (f0 + 0.5 * np.random.RandomState(0).randn(500)).astype(np.float32)
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), coords, "cpu")
    lmax = float(g.lmax_bound())
    return g, tg, f0, y, lmax


@pytest.mark.parametrize(
    "backend,opts",
    [("dense", {}), ("bsr", {}), ("bsr", {"fuse": False})],
    ids=["dense", "bsr-fused", "bsr-stepwise"],
)
def test_paper_denoising_slice_matches_reference(paper, backend, opts):
    g, tg, f0, y, lmax = paper
    want = np.asarray(japps.denoise_tikhonov(g, jnp.asarray(y), lmax))
    got = tapps.denoise_tikhonov(tg, torch.as_tensor(y), lmax, backend=backend, **opts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mse_ref = float(np.mean((want - f0) ** 2))
    mse_port = float(np.mean((got.numpy() - f0) ** 2))
    assert abs(mse_port - mse_ref) < 1e-6
    assert mse_port < 0.02 and 0.2 < float(np.mean((y - f0) ** 2)) < 0.3
    heat_ref = np.asarray(japps.smooth_heat(g, jnp.asarray(y), lmax, t=2.0))
    heat = tapps.smooth_heat(tg, torch.as_tensor(y), lmax, t=2.0, backend=backend, **opts)
    np.testing.assert_allclose(heat.numpy(), heat_ref, rtol=1e-5, atol=1e-5)


def test_paper_ssl_matches_reference(paper):
    g, tg, f0, _, lmax = paper
    true_label = np.where(f0 >= np.median(f0), 1.0, -1.0).astype(np.float32)
    mask = np.random.RandomState(1).rand(500) < 0.1
    labels = np.where(mask, true_label, 0.0).astype(np.float32)
    want = np.asarray(japps.ssl_classify(g, jnp.asarray(labels), lmax))
    got = tapps.ssl_classify(tg, torch.as_tensor(labels), lmax, backend="bsr")
    scores = np.asarray(japps.denoise_tikhonov(g, jnp.asarray(labels), lmax))
    decided = np.abs(scores) > 1e-5  # a sign within float noise of 0 may flip
    assert np.array_equal(got.numpy()[decided], want[decided])
    assert np.mean(got.numpy()[~mask] == true_label[~mask]) > 0.8
    with pytest.raises(TypeError, match="SensorGraph"):
        tapps.smooth_heat(np.zeros((3, 3)), torch.zeros(3), 1.0)
