"""Port parity for the training loop around the backward pass:
``repro_torch.data``, ``repro_torch.launch.donation``, the in-place
AdamW, ``make_train_step``, ``Trainer`` with restarts and checkpoints,
and the entry points ``repro_torch.launch.train`` and
``repro_torch.train_lm``.

* Pipeline: a batch depends on ``(seed, step)`` only; fed the reference's
  own ``base`` draw, the port's token transform gives the reference's
  tokens and labels exactly; frontend labels are -1; ``make_batch_specs``
  equals the reference's shapes and dtypes.
* Donation: the tables equal the reference's; a donated step keeps every
  leaf's storage and consumes its inputs, an undonated one keeps them;
  the in-place AdamW equals the out-of-place one bit for bit.
* ``make_train_step`` against the reference's jitted step, 2
  microbatches: loss within 1e-5, moments within 1e-5 of their scale,
  params within 2 lr per step taken (at step 1 AdamW moves an entry by
  ``+-lr`` whatever its gradient's size, so a near-zero gradient whose
  sign differs between the packages costs 2 lr).
* ``Trainer``: failures at steps 12 and 23 end at step 30 after 2
  restarts (``tests/test_substrate.py``); checkpoints of a port run
  restore in the reference bit for bit and back; a stacked run
  checkpoints its host replica in the unstacked layout.
"""

import dataclasses
import json
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import registry as jreg
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.data import make_batch_specs as jmake_batch_specs
from repro.launch import donation as jdonation
from repro.models import config as jconfig
from repro.models.config import ParallelConfig as JPar
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import interop, train_lm
from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import registry as treg
from repro_torch.core.collectives import StackedMesh
from repro_torch.data import SyntheticTokenPipeline, make_batch_specs, sensor_field_batch
from repro_torch.data import token_transform
from repro_torch.launch import donation
from repro_torch.launch import train as launch_train
from repro_torch.models import config as tconfig
from repro_torch.models import lm as tlm
from repro_torch.models.config import ParallelConfig as TPar
from repro_torch.optim import AdamWConfig, adamw_update, adamw_update_, init_opt_state
from repro_torch.runtime import FailureInjector, run_with_restarts
from repro_torch.train import (HOST_REPLICA, Trainer, make_gossip_train_step, make_train_step,
                               replica, replicate)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

PAR = TPar(attn_impl="naive", remat="none")


def _jnp_copy(a):
    """A jax array of its own (``jnp.asarray`` of a CPU tensor's numpy view
    can share the tensor's memory, which a donated step then rewrites)."""
    return jnp.asarray(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its steps are many small eager
    ops, and under the suite's parallel workers torch's thread teams
    oversubscribe the cores (a 3 s ``Trainer`` test took minutes).
    Single-threaded, the first ``torch.exp`` needs no warm-up either
    (``tests/test_torch_core.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---- the data pipeline ------------------------------------------------------


def test_pipeline_batch_depends_on_seed_and_step_only():
    pipe = SyntheticTokenPipeline(vocab_size=100, seq_len=16, global_batch=4, device="cpu")
    later = pipe.batch_at(7)
    first = SyntheticTokenPipeline(100, 16, 4, device="cpu").batch_at(7)  # a fresh pipeline
    pipe.batch_at(3)
    assert _equal(later, first) and _equal(pipe.batch_at(7), first)
    assert not torch.equal(pipe.batch_at(8)["tokens"], first["tokens"])
    other = SyntheticTokenPipeline(100, 16, 4, seed=1, device="cpu").batch_at(7)
    assert not torch.equal(other["tokens"], first["tokens"])
    assert first["tokens"].dtype == first["labels"].dtype == torch.int32
    assert first["tokens"].shape == first["labels"].shape == (4, 16)
    assert int(first["tokens"].min()) >= 0 and int(first["tokens"].max()) < 100


@pytest.mark.parametrize("frontend", [0, 3])
def test_token_transform_matches_reference(frontend):
    vocab, seq, batch, seed, step = 1000, 16, 4, 5, 9
    ref = JPipeline(vocab, seq, batch, seed=seed, frontend_positions=frontend, d_model=8)
    want = ref.batch_at(step)
    # the reference's own draw of base (repro/data/pipeline.py:35-40)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    kt, _ = jax.random.split(key)
    base = np.asarray(jax.random.randint(kt, (batch, seq + 1), 0, vocab))
    tokens, labels = token_transform(base, vocab)
    np.testing.assert_array_equal(tokens, np.asarray(want["tokens"]))
    if frontend:
        labels = labels.copy()
        labels[:, :frontend] = -1
    np.testing.assert_array_equal(labels, np.asarray(want["labels"]))
    got = SyntheticTokenPipeline(vocab, seq, batch, seed=seed, frontend_positions=frontend,
                                 d_model=8, device="cpu").batch_at(step)
    assert sorted(got) == sorted(want)
    if frontend:
        assert bool((got["labels"][:, :frontend] == -1).all())
        assert bool((got["labels"][:, frontend:] >= 0).all())
        assert got["extra_embeds"].shape == want["extra_embeds"].shape
        assert got["extra_embeds"].dtype == torch.float32
        assert want["extra_embeds"].dtype.name == "float32"


@pytest.mark.parametrize("shape", ["train", "prefill", "decode"])
def test_make_batch_specs_match_reference(shape):
    cfg_j, cfg_t = jreg.get_smoke("internvl2_2b"), treg.get_smoke("internvl2_2b")
    kind = {"train": 0, "prefill": 1, "decode": 2}[shape]
    shp_j = dataclasses.replace(jconfig.ALL_SHAPES[kind], frontend_positions=8)
    shp_t = dataclasses.replace(tconfig.ALL_SHAPES[kind], frontend_positions=8)
    assert shp_j.kind == shape
    want = jmake_batch_specs(cfg_j, shp_j)
    got = make_batch_specs(cfg_t, shp_t)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
        == {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


def test_sensor_field_batch_is_a_noisy_quadratic_field():
    coords = torch.rand(50, 2, generator=torch.Generator().manual_seed(0))
    clean, noisy = sensor_field_batch(torch.Generator().manual_seed(1), coords, 3, noise_std=0.5)
    again, _ = sensor_field_batch(torch.Generator().manual_seed(1), coords, 3, noise_std=0.5)
    assert clean.shape == noisy.shape == (50, 3) and torch.equal(clean, again)
    x, y = coords[:, 0], coords[:, 1]
    basis = torch.stack([x * x, y * y, x * y, x, y], dim=1)
    fit = torch.linalg.lstsq(basis, clean).solution
    assert float((basis @ fit - clean).abs().max()) < 1e-4
    assert 0.3 < float((noisy - clean).std()) < 0.7


# ---- donation and the in-place optimiser ---------------------------------------


def test_donation_tables_equal_reference():
    assert donation.TRAIN_DONATE == jdonation.TRAIN_DONATE == (0, 1)
    assert donation.DECODE_DONATE == jdonation.DECODE_DONATE == (2,)
    assert donation.PREFILL_DONATE == jdonation.PREFILL_DONATE == ()


def _smoke_setup(arch="gemma2_2b", seed=0):
    cfg = treg.get_smoke(arch)
    optc = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    params, _ = tlm.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return cfg, optc, params, init_opt_state(params, optc)


def test_donated_step_keeps_storage_and_consumes_its_inputs():
    cfg, optc, params, opt = _smoke_setup()
    batch = SyntheticTokenPipeline(cfg.vocab_size, 16, 2, device="cpu").batch_at(0)
    kept_p, kept_o = _clone(params), _clone(opt)
    step = make_train_step(cfg, PAR, optc)
    want_p, want_o, want_m = donation.jit_train_step(step, donate=False)(params, opt, batch)
    assert _equal(params, kept_p) and _equal(opt, kept_o)  # undonated: inputs kept
    ptrs = [t.data_ptr() for t in tree_leaves((params, opt))]
    got_p, got_o, got_m = donation.jit_train_step(step)(params, opt, batch)
    assert [t.data_ptr() for t in tree_leaves((got_p, got_o))] == ptrs
    assert got_p is params and got_o is opt
    assert not _equal(params, kept_p)  # consumed: the inputs now hold the new values
    assert _equal(got_p, want_p) and _equal(got_o, want_o)  # in place = out of place, bitwise
    assert float(got_m["loss"]) == float(want_m["loss"]) and int(got_o["step"]) == 1


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ranks", [None, 3])
def test_inplace_adamw_equals_out_of_place_bit_for_bit(moment_dtype, ranks):
    r = np.random.default_rng(3)
    lead = () if ranks is None else (ranks,)
    params = {"w": torch.from_numpy(r.normal(size=lead + (16, 8)).astype(np.float32)),
              "emb": torch.from_numpy(r.normal(size=lead + (32, 4)).astype(np.float32))
              .bfloat16(), "b": torch.from_numpy(r.normal(size=lead + (5,)).astype(np.float32))}
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=1.0,
                      moment_dtype=moment_dtype)
    state = init_opt_state(params, cfg)
    if ranks is not None:
        state = {**state, "step": state["step"].expand(ranks).clone()}
    p_out, s_out = _clone(params), _clone(state)
    p_in, s_in = _clone(params), _clone(state)
    for k in range(4):
        grads = tree_map(lambda t: (3.0 * torch.from_numpy(
            r.normal(size=tuple(t.shape)).astype(np.float32))).to(t.dtype), params)
        p_out, s_out, m_out = adamw_update(p_out, grads, s_out, cfg)
        ptrs = [t.data_ptr() for t in tree_leaves((p_in, s_in))]
        p_in, s_in, m_in = adamw_update_(p_in, grads, s_in, cfg)
        assert [t.data_ptr() for t in tree_leaves((p_in, s_in))] == ptrs
        assert _equal(p_in, p_out) and _equal(s_in, s_out)
        assert torch.equal(m_in["grad_norm"], m_out["grad_norm"])
        assert torch.equal(m_in["lr"], m_out["lr"])
    assert tuple(m_out["grad_norm"].shape) == lead


def test_stacked_adamw_clips_each_rank_by_its_own_norm():
    # inside shard_map each rank clips by its own gradient norm
    r = np.random.default_rng(4)
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    params = {"w": torch.from_numpy(r.normal(size=(3, 6, 4)).astype(np.float32)),
              "b": torch.from_numpy(r.normal(size=(3, 4)).astype(np.float32))}
    scale = torch.tensor([0.1, 1.0, 30.0])  # one rank under the clip norm, two over
    grads = tree_map(lambda t: t * scale.reshape((3,) + (1,) * (t.dim() - 1)), params)
    state = replicate(init_opt_state(replica(params, 0), cfg), 3)
    new_p, _, met = adamw_update(params, grads, state, cfg)
    for k in range(3):
        p1, _, m1 = adamw_update(replica(params, k), replica(grads, k),
                                 init_opt_state(replica(params, k), cfg), cfg)
        assert float(met["grad_norm"][k]) == pytest.approx(float(m1["grad_norm"]), rel=1e-6)
        for a, b in zip(tree_leaves(replica(new_p, k)), tree_leaves(p1)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---- make_train_step against the reference ----------------------------------------


def test_train_step_matches_reference_after_one_and_three_steps():
    cfg_j, cfg_t = jreg.get_smoke("llama3_405b"), treg.get_smoke("llama3_405b")
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)
    optc, joptc = AdamWConfig(**kw), JAdamWConfig(**kw)
    par_j = JPar(attn_impl="naive", remat="none", microbatches=2)
    par_t = TPar(attn_impl="naive", remat="none", microbatches=2)
    params, _ = tlm.init(torch.Generator().manual_seed(7), cfg_t, "cpu")
    jparams = jax.tree.map(_jnp_copy, interop.cache_to_numpy(params))
    opt, jopt = init_opt_state(params, optc), jinit_opt_state(jparams, joptc)
    jstep = jax.jit(jmake_train_step(cfg_j, par_j, joptc))
    step = make_train_step(cfg_t, par_t, optc)
    pipe = SyntheticTokenPipeline(cfg_t.vocab_size, 16, 4, device="cpu")
    lr_sum = 0.0
    for k in range(3):
        batch = pipe.batch_at(k)
        params, opt, m = step(params, opt, batch)
        jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                                             batch))
        lr_sum += float(jm["lr"])
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert int(opt["step"]) == int(jopt["step"]) == k + 1
        for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
            assert float((a - torch.from_numpy(np.asarray(b))).abs().max()) <= 2 * lr_sum + 1e-6
        if k == 0:  # the moments hold the step-1 gradient itself
            for name in ("m", "v"):
                for a, b in zip(tree_leaves(opt[name]), jax.tree.leaves(jopt[name])):
                    b = np.asarray(b)
                    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                               atol=1e-5 * np.abs(b).max() + 1e-12)


# ---- Trainer, restarts and checkpoints ------------------------------------------------


def _training_setup(tmp_path, fail_at=(), steps=30):
    cfg, optc, _, _ = _smoke_setup()
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq_len=32, global_batch=4, device="cpu")
    step_fn = donation.jit_train_step(make_train_step(cfg, PAR, optc))
    mgr = CheckpointManager(tmp_path, keep=3)
    injector = FailureInjector(fail_at) if fail_at else None  # a lost node stays lost

    def make_trainer(start_step):
        params, _ = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
        opt = init_opt_state(params, optc)
        if start_step > 0:
            snap = restore(tmp_path, start_step, {"params": params, "opt": opt}, device="cpu")
            params, opt = snap["params"], snap["opt"]
        return Trainer(train_step=step_fn, pipeline=pipe, ckpt=mgr, params=params,
                       opt_state=opt, ckpt_every=5, failure_injector=injector)

    return make_trainer


def test_training_loss_decreases(tmp_path):
    result = _training_setup(tmp_path)(0).run(30)
    assert result["final_step"] == 30 and len(result["step_s"]) == 30
    assert np.mean(result["losses"][-5:]) < np.mean(result["losses"][:5]) - 0.1
    assert math.isfinite(result["grad_norm"]) and result["lr"] > 0


def test_restart_from_checkpoint_after_failures(tmp_path):
    # tests/test_substrate.py::test_restart_from_checkpoint_after_failure
    make_trainer = _training_setup(tmp_path, fail_at=(12, 23))
    result = run_with_restarts(make_trainer, 30, latest_step_fn=lambda: latest_step(tmp_path))
    assert result["final_step"] == 30
    assert result["restarts"] == 2
    assert latest_step(tmp_path) == 30
    # the resumed run regenerates the batches of an uninterrupted one
    whole = _training_setup(tmp_path / "whole")(0).run(30)
    np.testing.assert_allclose(result["losses"], whole["losses"][20:], rtol=0, atol=1e-5)


def test_trainer_checkpoints_cross_between_packages(tmp_path):
    make_trainer = _training_setup(tmp_path, steps=3)
    trainer = make_trainer(0)
    trainer.run(3)
    state = {"params": trainer.params, "opt": trainer.opt_state}
    # port -> reference, bit for bit
    like = jax.tree.map(_jnp_copy, interop.cache_to_numpy(state))
    back = jrestore(tmp_path, 3, like)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(back)):
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # reference -> port: the restored state carried across, and the
    # reference's save of it restored by the port
    assert _equal(interop.opt_state_from_numpy(jax.tree.map(np.asarray, back["opt"]), "cpu"),
                  state["opt"])
    jsave(tmp_path / "ref", 7, back)
    got = restore(tmp_path / "ref", 7, state, device="cpu")
    assert _equal(got, state)


def test_stacked_trainer_checkpoints_the_host_replica(tmp_path):
    cfg, optc, params, opt = _smoke_setup("codeqwen15_7b")
    mesh = StackedMesh(2, "cpu")
    par = TPar(attn_impl="naive", remat="none", grad_sync="gossip", gossip_order=1)
    step = donation.jit_train_step(make_gossip_train_step(cfg, par, optc, None, mesh))
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 16, 4, device="cpu")
    trainer = Trainer(train_step=step, pipeline=pipe, ckpt=CheckpointManager(tmp_path),
                      params=replicate(params, 2), opt_state=replicate(opt, 2),
                      host_replica=HOST_REPLICA)
    trainer.run(2)
    w = tree_leaves(trainer.params)[0]
    assert not torch.equal(w[0], w[1])  # order 1 on 2 ranks: the replicas drift
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["treedef"] == str(tree_flatten({"params": params, "opt": opt})[1])
    host = replica({"params": trainer.params, "opt": trainer.opt_state}, HOST_REPLICA)
    assert _equal(restore(tmp_path, 2, host, device="cpu"), host)


# ---- the entry points --------------------------------------------------------------


def test_launcher_trains_on_cpu(tmp_path):
    rec = launch_train.main(["--arch", "gemma2_2b", "--smoke", "--steps", "5", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    assert rec["steps"] == 5 and rec["restarts"] == 0 and rec["device"] == "cpu"
    assert len(rec["losses"]) == 5 and all(math.isfinite(x) for x in rec["losses"])
    assert latest_step(tmp_path) == 5


def test_launcher_gossip_on_cpu(tmp_path):
    rec = launch_train.main(["--arch", "codeqwen15_7b", "--smoke", "--steps", "3", "--device",
                             "cpu", "--grad-sync", "gossip", "--n-parts", "4", "--ckpt-dir",
                             str(tmp_path)])
    assert rec["steps"] == 3 and all(math.isfinite(x) for x in rec["losses"])
    # the checkpoint holds one replica in the reference's unstacked layout
    params, _ = tlm.init(torch.Generator().manual_seed(0), treg.get_smoke("codeqwen15_7b"), "cpu")
    snap = restore(tmp_path, 3, {"params": params}, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(snap)] == [tuple(t.shape)
                                                          for t in tree_leaves(params)]


def test_launcher_dryrun_exits_with_a_message(capsys):
    # --dryrun hands the cell to ``repro_torch.launch.dryrun.main``,
    # which traces it on meta tensors and prints its roofline line
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "gemma2_2b", "--dryrun"])
    assert exc.value.code == 0
    assert "[gemma2_2b.train_4k] trace=" in capsys.readouterr().out


@pytest.mark.parametrize("grad_sync", ["allreduce", "gossip"])
def test_train_lm_tiny_on_cpu(grad_sync, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rec = train_lm.main(["--preset", "tiny", "--device", "cpu", "--grad-sync", grad_sync,
                         "--n-parts", "4"])
    assert rec["steps"] == 3 and all(math.isfinite(x) for x in rec["losses"])
    assert rec["ckpt_dir"].startswith(str(tmp_path))


def test_train_lm_presets_equal_the_reference_example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("ref_train_lm", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert train_lm.PRESETS == ref.PRESETS


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticTokenPipeline(100, 8, 2).batch_at(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "gemma2_2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--preset", "tiny"])
