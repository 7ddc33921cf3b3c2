"""Port parity for the model-free training substrate: ``repro_torch.tree``,
``repro_torch.train`` (buckets), ``repro_torch.optim`` (AdamW),
``repro_torch.runtime`` (fault runtime) and ``repro_torch.checkpoint``,
held against the JAX package on the same numpy inputs.

* Flattening order and key paths equal ``jax.tree_util``'s (dict keys
  sorted), so bucket plans equal the reference's exactly and checkpoint
  keys, dtypes, shapes and tree strings match.
* AdamW: 10 steps within 1e-6 of ``repro.optim.adamw_update``, with
  float32 and bfloat16 moments.
* Checkpoints written by either package restore in the other bit for
  bit, bfloat16 and both float8 formats included.
* The fault runtime is host code: its counts and flags are checked on
  injected timestamps, not on wall time.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.optim import adamw as jadamw
from repro.train import buckets as jbuckets
from repro_torch import checkpoint, optim, runtime, tree
from repro_torch.train import build_bucket_plan, pack_buckets, unpack_buckets


def _np_tree(seed: int = 0) -> dict:
    """The reference bucket tests' tree shape (``tests/test_train_schedules.py``),
    from numpy, dict keys out of sorted order."""
    rng = np.random.default_rng(seed)
    return {
        "w": {"b": rng.normal(size=(7,)).astype(np.float32),
              "a": rng.normal(size=(16, 16)).astype(np.float32)},
        "emb": rng.normal(size=(32, 8)).astype(np.float32),
        "bias": rng.normal(size=(3, 2)).astype(np.float32),
    }


def _to_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _to_torch(t):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), t)


# ---- the pytree helper ----------------------------------------------------


def test_tree_order_paths_and_structure_match_jax():
    t = {"z": [np.zeros(2), (np.ones(3), None, {"q": np.zeros(1), "b": np.ones(1)})],
         "a": np.arange(4), "m": {"y": np.zeros(()), "c": [np.ones(2)]}}
    leaves, treedef = tree.tree_flatten(t)
    jleaves, jdef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == len(jleaves)
    assert all(a is b for a, b in zip(leaves, jleaves))
    assert str(treedef) == str(jdef)
    paths = [p for p, _ in tree.tree_flatten_with_path(t)[0]]
    jpaths = ["/".join(jstore._path_str(k) for k in kp)
              for kp, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths == jpaths
    back = tree.tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == jdef
    doubled = tree.tree_map(lambda x, y: x + y, t, t)
    assert np.array_equal(doubled["m"]["c"][0], 2 * np.ones(2))
    with pytest.raises(ValueError, match="differ"):
        tree.tree_map(lambda x, y: x, t, {"a": 1})
    with pytest.raises(ValueError, match="too many"):
        tree.tree_unflatten(treedef, leaves + [np.zeros(1)])


# ---- buckets --------------------------------------------------------------


def _sized_tree(sizes, seed):
    """Leaves of the given sizes under shuffled, unsorted keys (ties included)."""
    rng = np.random.default_rng(seed)
    keys = [f"k{i:02d}" for i in range(len(sizes))]
    rng.shuffle(keys)
    return {k: np.zeros((s,), np.float32) for k, s in zip(keys, sizes)}


@pytest.mark.parametrize("case", ["schedules", "ties", "lm-like"])
@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 99])
def test_bucket_plans_equal_the_reference(case, n_buckets):
    t = {"schedules": _np_tree(),
         "ties": _sized_tree([5, 5, 5, 3, 3, 8, 8, 1], seed=1),
         "lm-like": _sized_tree([4096, 64, 64, 1024, 1024, 64, 4096, 16, 16, 2048], seed=2)}[case]
    plan = build_bucket_plan(_to_torch(t), n_buckets)
    want = jbuckets.build_bucket_plan(_to_jax(t), n_buckets)
    assert plan.buckets == want.buckets and plan.sizes == want.sizes
    assert plan.shapes == want.shapes and plan.n_buckets == want.n_buckets
    assert [str(d).removeprefix("torch.") for d in plan.dtypes] == [d.name for d in want.dtypes]
    assert plan.imbalance() == pytest.approx(want.imbalance())
    assert str(plan.treedef) == str(want.treedef)
    flats = pack_buckets(plan, _to_torch(t))
    jflats = jbuckets.pack_buckets(want, _to_jax(t))
    for a, b in zip(flats, jflats):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        build_bucket_plan(_to_torch(t), 0)


def test_pack_unpack_round_trip_with_mixed_dtypes_and_a_rank_axis():
    t = _to_torch(_np_tree(3))
    t["w"]["a"] = t["w"]["a"].bfloat16()
    plan = build_bucket_plan(t, 2)
    back = unpack_buckets(plan, pack_buckets(plan, t))
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a leading rank axis the plan does not see: plan from one rank's leaves
    ranked = tree.tree_map(lambda v: torch.stack([v, 2 * v, -v]), t)
    rplan = build_bucket_plan(tree.tree_map(lambda v: v[0], ranked), 2)
    assert rplan.buckets == plan.buckets
    flats = pack_buckets(rplan, ranked)
    assert [tuple(f.shape) for f in flats] == [(3, s) for s in rplan.sizes]
    back = unpack_buckets(rplan, flats)
    for a, b in zip(tree.tree_leaves(ranked), tree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="plan's shapes"):
        pack_buckets(rplan, tree.tree_map(lambda v: v[:2] if v.dim() == 3 else v, ranked))


# ---- AdamW ----------------------------------------------------------------


def test_cosine_schedule_matches_reference_on_a_step_grid():
    cfg = optim.AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jadamw.AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    for step in [0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150]:
        got = optim.cosine_schedule(cfg, step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(float(jadamw.cosine_schedule(jcfg, step)),
                                           rel=1e-6, abs=1e-12)
    assert float(optim.cosine_schedule(cfg, 0)) == 0.0
    assert float(optim.cosine_schedule(cfg, 10)) == pytest.approx(1e-3)
    assert float(optim.cosine_schedule(cfg, 100)) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_ten_steps_match_reference(moment_dtype):
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=5.0,
              moment_dtype=moment_dtype)
    cfg, jcfg = optim.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    params_np = _np_tree(4)
    p, jp = _to_torch(params_np), _to_jax(params_np)
    st, jst = optim.init_opt_state(p, cfg), jadamw.init_opt_state(jp, jcfg)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert str(tree.tree_leaves(st["m"])[0].dtype) == f"torch.{moment_dtype}"
    assert optim.opt_state_specs({"a": 1}) == jadamw.opt_state_specs({"a": 1})
    rng = np.random.default_rng(5)
    for _ in range(10):
        g_np = jax.tree_util.tree_map(
            lambda v: (3.0 * rng.normal(size=v.shape)).astype(np.float32), params_np)
        p, st, met = optim.adamw_update(p, _to_torch(g_np), st, cfg)
        jp, jst, jmet = jadamw.adamw_update(jp, _to_jax(g_np), jst, jcfg)
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-6)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(st["step"]) == int(jst["step"]) == 10
    for name, got, want in (("params", p, jp), ("m", st["m"], jst["m"]), ("v", st["v"], jst["v"])):
        for a, b in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert str(a.dtype).removeprefix("torch.") == b.dtype.name, name
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_clip_by_global_norm_matches_reference():
    g_np = jax.tree_util.tree_map(lambda v: 10 * v, _np_tree(6))
    got, gn = optim.clip_by_global_norm(_to_torch(g_np), 1.0)
    want, jgn = jadamw.clip_by_global_norm(_to_jax(g_np), 1.0)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    for a, b in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---- checkpoints ----------------------------------------------------------


def _ckpt_tree_np():
    """The reference's ``test_checkpoint_roundtrip`` tree, plus both fp8
    formats and an unsorted dict."""
    rng = np.random.default_rng(7)
    return {
        "a": np.arange(6).reshape(2, 3).astype(ml_dtypes.bfloat16),
        "b": [np.ones((4,), np.float32), {"c": np.zeros((), np.int32)}],
        "f8": {"e5": rng.normal(size=(3, 2)).astype(ml_dtypes.float8_e5m2),
               "e4": rng.normal(size=(5,)).astype(ml_dtypes.float8_e4m3fn)},
        "s": np.array(2.5, ml_dtypes.bfloat16),
    }


_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}


def _np_to_torch(v: np.ndarray) -> torch.Tensor:
    name = v.dtype.name
    if name in _TORCH_DTYPE:
        raw = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
        return torch.from_numpy(raw.copy()).view(_TORCH_DTYPE[name]).reshape(v.shape)
    return torch.from_numpy(v.copy())


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json").read_text())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_restore_bit_for_bit(tmp_path, writer):
    t_np = _ckpt_tree_np()
    t_port = jax.tree_util.tree_map(_np_to_torch, t_np)
    t_ref = jax.tree_util.tree_map(jnp.asarray, t_np)
    (jstore.save if writer == "reference" else checkpoint.save)(
        tmp_path, 3, t_ref if writer == "reference" else t_port)
    assert checkpoint.latest_step(tmp_path) == jstore.latest_step(tmp_path) == 3
    back_port = checkpoint.restore(tmp_path, 3, t_port, device="cpu")
    back_ref = jstore.restore(tmp_path, 3, t_ref)
    for want, a, b in zip(jax.tree_util.tree_leaves(t_np), tree.tree_leaves(back_port),
                          jax.tree_util.tree_leaves(back_ref)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert tuple(a.shape) == want.shape == b.shape
        assert str(a.dtype).removeprefix("torch.") == want.dtype.name == b.dtype.name
        assert _bytes(a) == _bytes(want) == _bytes(b)


def test_manifests_of_both_packages_agree(tmp_path):
    t_np = _ckpt_tree_np()
    jstore.save(tmp_path / "ref", 1, jax.tree_util.tree_map(jnp.asarray, t_np))
    checkpoint.save(tmp_path / "port", 1, jax.tree_util.tree_map(_np_to_torch, t_np))
    assert _manifest(tmp_path / "port", 1) == _manifest(tmp_path / "ref", 1)
    with np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as p, \
            np.load(tmp_path / "ref" / "step_00000001" / "arrays.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for k in p.files:
            assert p[k].dtype == r[k].dtype and np.array_equal(p[k], r[k])


def test_restore_checks_shapes_and_resharded_casts(tmp_path):
    t = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": torch.tensor(4)}
    checkpoint.save(tmp_path, 5, t)
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.restore(tmp_path, 5, {"x": torch.zeros(3, 2), "n": torch.tensor(0)},
                           device="cpu")
    like = {"x": torch.zeros(2, 3, dtype=torch.bfloat16), "n": torch.tensor(0, dtype=torch.int32)}
    back = checkpoint.restore_resharded(tmp_path, 5, like, device="cpu")
    assert back["x"].dtype == torch.bfloat16 and back["n"].dtype == torch.int32
    assert torch.equal(back["x"].float(), t["x"]) and int(back["n"]) == 4


def test_checkpoint_manager_async_keeps_two(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    x = torch.zeros(4)
    for s in (1, 2, 3):
        x.fill_(s)
        mgr.save_async(s, {"x": x})
        x.fill_(-1.0)  # after save_async returns: the snapshot is already taken
    mgr.wait()
    assert checkpoint.latest_step(tmp_path) == 3
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [2, 3]
    for s in (2, 3):
        back = checkpoint.restore(tmp_path, s, {"x": x}, device="cpu")
        assert torch.equal(back["x"], torch.full((4,), float(s)))
        assert np.array_equal(jstore.restore(tmp_path, s, {"x": jnp.zeros(4)})["x"],
                              np.full(4, s, np.float32))


def test_checkpoint_manager_surfaces_write_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = checkpoint.CheckpointManager(blocker)
    mgr.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


# ---- fault runtime --------------------------------------------------------


def test_failure_injector_fires_once():
    inj = runtime.FailureInjector([3])
    inj(2)
    with pytest.raises(runtime.WorkerFailure):
        inj(3)
    inj(3)  # second pass does not raise


class _ToyTrainer:
    """Counts steps on a checkpointed state; a shared injector loses a node."""

    def __init__(self, ckpt_dir, start_step, injector, every=5):
        self.ckpt_dir, self.injector, self.every = ckpt_dir, injector, every
        self.state = {"w": torch.zeros(3), "step": torch.tensor(0, dtype=torch.int32)}
        if start_step:
            self.state = checkpoint.restore(ckpt_dir, start_step, self.state, device="cpu")

    def run(self, n_steps, start_step=0):
        for step in range(start_step, n_steps):
            self.injector(step)
            self.state = {"w": self.state["w"] + 1.0, "step": self.state["step"] + 1}
            if (step + 1) % self.every == 0:
                checkpoint.save(self.ckpt_dir, step + 1, self.state)
        return {"final_step": int(self.state["step"]), "w": self.state["w"]}


def test_run_with_restarts_restores_and_counts(tmp_path):
    injector = runtime.FailureInjector([12, 23])
    res = runtime.run_with_restarts(
        lambda start: _ToyTrainer(tmp_path, start, injector), 30,
        latest_step_fn=lambda: checkpoint.latest_step(tmp_path))
    assert res["final_step"] == 30 and res["restarts"] == 2
    assert torch.equal(res["w"], torch.full((3,), 30.0))  # no step lost or repeated
    assert checkpoint.latest_step(tmp_path) == 30
    always = runtime.FailureInjector(range(100))
    with pytest.raises(runtime.WorkerFailure):
        runtime.run_with_restarts(lambda start: _ToyTrainer(tmp_path / "b", start, always), 30,
                                  latest_step_fn=lambda: None, max_restarts=2)


def test_straggler_monitor_flags_outliers_on_injected_timestamps(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(runtime.fault.time, "monotonic", lambda: now[0])
    mon = runtime.StragglerMonitor(window=16, threshold=2.0)
    for step in range(12):
        assert mon.tick(step) is False
        now[0] += 0.01
    assert mon.tick(99) is False  # a normal gap
    now[0] += 0.08  # 8x the median gap before the next tick
    assert mon.tick(100) is True
    now[0] += 0.01
    assert mon.tick(101) is False
    assert mon.flagged == [100]


def test_straggler_injector_counts_and_charges_delays(monkeypatch):
    slept = []
    monkeypatch.setattr(runtime.fault.time, "sleep", slept.append)
    inj = runtime.StragglerInjector(alpha_ms=1.0, rank_delay_ms={0: 5.0})
    inj.gossip_round(0, 0, 4)  # 4 msgs * 1 ms + 5 ms rank delay
    inj.gossip_round(3, 0, 4)  # non-straggler rank: alpha only
    inj.allreduce_barrier(0, 14)  # (1 + 5) ms * 14 phases
    assert inj.rounds_injected == 3
    assert slept == pytest.approx([0.009, 0.004, 0.084])
    quick = runtime.StragglerInjector()
    quick.gossip_round(0, 0, 100)
    assert quick.rounds_injected == 1 and len(slept) == 3  # a zero delay never sleeps
