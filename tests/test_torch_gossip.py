"""Port parity for Chebyshev gossip consensus: ``repro_torch.core.gossip``
and the meshes' cyclic ring exchange, held against ``repro.core.gossip``
on the same numpy inputs.

* The oracle runs the reference in-process as
  ``jax.vmap(..., axis_name="data")`` (vmap-as-mesh). Port on a
  ``StackedMesh(P)`` against it: 1e-6 with f32 payloads, 1e-5 with bf16,
  for P in {2, 3, 8, 16} (P = 3 takes the degenerate-spectrum branch,
  P = 2 the same-peer ring), orders 2-16, with and without truncation.
* Under ``vmap`` the reference's ``measured_ppermute_words`` reads 0 (no
  ``ppermute`` survives batching), so the port's measured words are held
  to the reference's analytic ``gossip_message_words`` exactly.
* The reference's ``round_delay`` callback is not run under ``vmap``; the
  port's hook count is pinned to ``P * (M - r)`` instead.
* The host helpers (coefficients, truncation profile, orders, words)
  equal the reference's (1e-12 for the float64 ones).
* One test spawns 4 gloo ranks and holds ``GroupMesh`` gossip against
  ``StackedMesh(4)`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro_torch import gossip_consensus
from repro_torch.core import collectives
from repro_torch.core import gossip
from repro_torch.runtime import StragglerInjector
from repro_torch.tree import tree_map
from test_torch_distributed import run_gloo_ranks

F32_TOL, BF16_TOL = 1e-6, 1e-5


def _grads(p: int, seed: int = 0) -> dict:
    """One small gradient tree per rank (leading axis = rank); dict keys
    out of sorted order on purpose."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(p, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(p, 4)).astype(np.float32)}


def _port(tree: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _reference(tree: dict, p: int, **kw) -> dict:
    fn = jax.vmap(lambda g: jgossip.chebyshev_gossip_mean(g, "data", p, **kw),
                  axis_name="data")
    out = fn({k: jnp.asarray(v) for k, v in tree.items()})
    return {k: np.asarray(v) for k, v in out.items()}


_CASES = [(2, 0, None), (4, 0, "bfloat16"), (10, 0, None), (10, 4, "bfloat16"),
          (16, 0, "bfloat16"), (16, 4, None)]


@pytest.mark.parametrize("p", [2, 3, 8, 16])
@pytest.mark.parametrize("order,truncate,payload", _CASES,
                         ids=[f"M{m}-r{r}-{pd or 'f32'}" for m, r, pd in _CASES])
def test_gossip_matches_reference(p, order, truncate, payload):
    tree = _grads(p, seed=p * 100 + order)
    mesh = collectives.StackedMesh(p, "cpu")
    kw = dict(order=order, truncate=truncate, payload_dtype=payload)
    want = _reference(tree, p, **kw)
    got = {}
    words = gossip.measured_ppermute_words(
        mesh, lambda: got.update(gossip.chebyshev_gossip_mean(_port(tree), mesh, **kw)))
    tol = F32_TOL if payload is None else BF16_TOL
    for k in tree:
        assert got[k].dtype == torch.float32 and got[k].shape == tree[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=tol, atol=tol)
    n = 5 * 3 + 4
    analytic = jgossip.gossip_message_words(order - truncate, p, n) // p
    if payload is None:
        assert words == analytic
    else:
        assert abs(words - analytic / 2) <= 1
    assert mesh.calls["ring"] == 2 * 2 * (order - truncate)  # 2 leaves, both directions
    assert set(mesh.calls) == {"ring"}


def test_reference_measured_words_read_zero_under_vmap():
    # The known difference the port's counter replaces: batching removes
    # every ppermute from the jaxpr, so the reference's walk reads 0.
    tree = {k: jnp.asarray(v) for k, v in _grads(8).items()}
    fn = jax.vmap(lambda g: jgossip.chebyshev_gossip_mean(g, "data", 8, order=4),
                  axis_name="data")
    assert jgossip.measured_ppermute_words(fn, tree) == 0


@pytest.mark.parametrize("payload", [None, "bfloat16"])
def test_ring_matvec_and_allreduce_match_reference(payload):
    p = 8
    tree = _grads(p, seed=3)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    want_lx = jax.vmap(lambda g: jgossip.ring_laplacian_matvec(g, "data", p, payload),
                       axis_name="data")(jt)
    want_mean = jax.vmap(lambda g: jgossip.pair_allreduce_mean(g, "data"), axis_name="data")(jt)
    mesh = collectives.StackedMesh(p, "cpu")
    got_lx = gossip.ring_laplacian_matvec(_port(tree), mesh, payload)
    got_mean = gossip.pair_allreduce_mean(_port(tree), mesh)
    for k in tree:
        np.testing.assert_allclose(got_lx[k].numpy(), np.asarray(want_lx[k]),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got_mean[k].numpy(), np.asarray(want_mean[k]),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("p", [1, 2, 5])
def test_ring_exchange_is_cyclic_and_counted_apart(p):
    mesh = collectives.StackedMesh(p, "cpu")
    x = torch.arange(p * 6, dtype=torch.float32).reshape(p, 3, 2)
    fwd, bwd = mesh.ring_fwd(x), mesh.ring_bwd(x)
    for i in range(p):
        assert torch.equal(fwd[(i + 1) % p], x[i])  # pairs (i, (i+1) % P)
        assert torch.equal(bwd[i], x[(i + 1) % p])  # pairs ((i+1) % P, i)
    mesh.ring_fwd(x.bfloat16())
    moved = 6 * p if p > 1 else 0
    assert mesh.calls == {"ring": 3}
    assert mesh.elements["ring"] == 3 * moved
    assert mesh.bytes["ring"] == 2 * 4 * moved + 2 * moved
    # the open shifts keep their zeros at the edge ranks and their own kind
    mesh.reset_counts()
    assert not mesh.shift_fwd(x)[0].any()
    assert set(mesh.calls) == {"shift"} and not mesh.bytes["ring"]


def test_one_rank_gossip_is_the_identity():
    mesh = collectives.StackedMesh(1, "cpu")
    tree = _port(_grads(1))
    assert gossip.chebyshev_gossip_mean(tree, mesh, order=4) is tree


@pytest.mark.parametrize("truncate,messages", [(0, None), (4, 12)])
def test_round_delay_hook_is_called_per_rank_per_round(truncate, messages):
    p, order = 8, 10
    mesh = collectives.StackedMesh(p, "cpu")
    calls = []
    inj = StragglerInjector(alpha_ms=0.0)

    def hook(rank, k, n_messages):
        calls.append((rank, k, n_messages))
        inj.gossip_round(rank, k, n_messages)

    plain = gossip.chebyshev_gossip_mean(_port(_grads(p)), mesh, order=order, truncate=truncate)
    hooked = gossip.chebyshev_gossip_mean(_port(_grads(p)), mesh, order=order, truncate=truncate,
                                          round_delay=hook, delay_salt=7, delay_messages=messages)
    rounds = order - truncate
    assert inj.rounds_injected == len(calls) == p * rounds
    assert calls == [(r, k, messages or 4) for k in range(rounds) for r in range(p)]
    for k in plain:
        assert torch.equal(plain[k], hooked[k])  # the hook changes no value


@pytest.mark.parametrize("n_buckets", [1, 2, 4])
def test_bucketed_gossip_equals_per_leaf_bit_for_bit(n_buckets):
    p = 8
    rng = np.random.default_rng(11)
    tree = {"z": rng.normal(size=(p, 6, 4)), "a": rng.normal(size=(p, 9)),
            "m": [rng.normal(size=(p, 3)), rng.normal(size=(p, 2, 2))]}
    tree = tree_map(lambda v: torch.from_numpy(v.astype(np.float32)), tree)
    mesh = collectives.StackedMesh(p, "cpu")
    serial = gossip.chebyshev_gossip_mean(tree, mesh, order=12)
    mesh.reset_counts()
    bucketed = gossip_consensus.sync_bucketed(tree, mesh, n_buckets, 12)
    assert mesh.calls["ring"] == 2 * 12 * min(n_buckets, 4)
    for a, b in zip(jax.tree_util.tree_leaves(serial), jax.tree_util.tree_leaves(bucketed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [2, 3, 8, 16, 32])
def test_host_helpers_match_reference(p):
    lam1, lmax = gossip.ring_spectrum_bounds(p)
    assert (lam1, lmax) == jgossip.ring_spectrum_bounds(p)
    assert gossip.required_order(p, 1e-3) == jgossip.required_order(p, 1e-3)
    for order in (2, 4, 10, 16):
        np.testing.assert_allclose(gossip.consensus_coefficients(order, lam1, lmax),
                                   jgossip.consensus_coefficients(order, lam1, lmax),
                                   rtol=0, atol=1e-12)
        assert gossip.consensus_contraction(order, lam1, lmax) == \
            jgossip.consensus_contraction(order, lam1, lmax)
        for truncate in {0, min(4, order - 1)}:
            np.testing.assert_allclose(gossip.truncation_profile(order, truncate, lam1, lmax),
                                       jgossip.truncation_profile(order, truncate, lam1, lmax),
                                       rtol=0, atol=1e-12)
        assert gossip.payload_roundoff_bound(order) == jgossip.payload_roundoff_bound(order)
        assert gossip.gossip_message_words(order, p, 2080) == \
            jgossip.gossip_message_words(order, p, 2080)
        for pdt in ("float32", "bfloat16"):
            assert gossip.gossip_message_bytes(order, p, 2080, pdt) == \
                jgossip.gossip_message_bytes(order, p, 2080, pdt)
    assert gossip.allreduce_message_words(p, 2080) == jgossip.allreduce_message_words(p, 2080)
    with pytest.raises(ValueError):
        gossip.truncation_profile(4, 4, lam1, lmax)
    with pytest.raises(ValueError):
        gossip.chebyshev_gossip_mean(_port(_grads(p)), collectives.StackedMesh(p, "cpu"),
                                     order=4, truncate=4)


def test_gossip_consensus_example_runs_on_cpu():
    res = gossip_consensus.main(device="cpu")
    for rel, bound in res["orders"].values():
        assert rel <= 1.05 * bound
    assert res["analytic_words"] == jgossip.gossip_message_words(12, 8, 2080) // 8 == 49920
    assert res["bucketed"]["bucketed f32"]["words"] == 49920
    assert abs(res["bucketed"]["bucketed bf16"]["words"] - 24960) <= 1
    assert res["bucketed"]["bucketed bf16"]["rel_err"] <= jgossip.payload_roundoff_bound(12)
    assert res["required_order_8"] == 10


_GLOO_GOSSIP = r"""
import sys
import torch.multiprocessing as mp


def rank_main(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    from repro_torch.core import gossip
    from repro_torch.core.collectives import GroupMesh, StackedMesh

    gen = torch.Generator().manual_seed(5)
    full = {"w": torch.randn(world, 6, 3, generator=gen), "b": torch.randn(world, 5, generator=gen)}
    mine = {k: v[rank:rank + 1].clone() for k, v in full.items()}
    gm, sm = GroupMesh(device="cpu"), StackedMesh(world, "cpu")
    worst = 0.0
    for kw in ({"order": 6}, {"order": 10, "truncate": 4}, {"order": 8, "payload_dtype": "bfloat16"}):
        got = {}
        words = gossip.measured_ppermute_words(
            gm, lambda: got.update(gossip.chebyshev_gossip_mean(mine, gm, **kw)))
        want = {}
        stacked_words = gossip.measured_ppermute_words(
            sm, lambda: want.update(gossip.chebyshev_gossip_mean(full, sm, **kw)))
        assert words == stacked_words, (kw, words, stacked_words)
        worst = max(worst, max(float((got[k][0] - want[k][rank]).abs().max()) for k in full))
    mean = gossip.pair_allreduce_mean(mine, gm)
    worst = max(worst, max(float((mean[k][0] - full[k].mean(0)).abs().max()) for k in full))
    assert worst < 1e-6, worst
    print(f"rank {rank} max|group - stacked| {worst:.2e}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(4, sys.argv[1]), nprocs=4, join=True)
    print("OK")
"""


def test_group_mesh_gossip_on_gloo_matches_stacked_mesh(tmp_path):
    """4 gloo ranks: ``GroupMesh`` gossip (full, truncated, bf16 payloads)
    and the all-reduce mean against ``StackedMesh(4)`` within 1e-6, with
    equal measured words per rank."""
    out = run_gloo_ranks(_GLOO_GOSSIP, tmp_path)
    assert out.count("max|group - stacked|") == 4 and "OK" in out
