"""Port parity for the data-parallel train steps on a ``StackedMesh``:
``make_gossip_train_step`` (serial, bucketed and delay-slot schedules,
bf16 payloads), ``make_barrier_train_step`` and
``make_local_sgd_train_step``.

* The oracle is the reference composed on one device: its own
  ``_accumulate_grads`` / ``_accumulate_grads_overlap``, bucket packing,
  ``chebyshev_gossip_mean``, ``adamw_update`` and ``pmean`` s, run per
  rank under ``jax.vmap(..., axis_name="data")`` (vmap-as-mesh, as
  ``tests/test_torch_gossip.py`` runs the reference's gossip). Held: the
  loss of every step within 1e-5, the first moments after step 1 within
  1e-5 of their scale (bf16 payloads: within the reference's
  ``payload_roundoff_bound(M)`` of it, since the packages round slightly
  different f32 values to bf16; one step), the params within 2 lr per
  step taken (the AdamW trap of ``tests/test_torch_train_loop.py``).
* Port schedules among themselves, as the reference's
  ``test_gossip_schedule_parity_and_error_models`` holds them: serial =
  bucketed and serial = delay-slot (2 microbatches) within 1e-5; the
  emulated-delay hooks count ``steps x P x M`` gossip rounds and ``P``
  barriers per step.
* One subprocess runs the reference's real ``shard_map`` gossip step on 8
  host devices for 3 steps beside the port's on ``StackedMesh(8)``, and
  pins which replica the reference's host read returns (``HOST_REPLICA``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models.config import ParallelConfig as JPar
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import buckets as jbuckets
from repro.train import trainer as jtrainer
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.core.collectives import StackedMesh
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.launch.donation import jit_train_step
from repro_torch.models import lm as tlm
from repro_torch.models.config import ParallelConfig as TPar
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import StragglerInjector
from repro_torch.train import (HOST_REPLICA, make_barrier_train_step, make_gossip_train_step,
                               make_local_sgd_train_step, replica, replicate)
from repro_torch.tree import tree_leaves, tree_map

ARCH, P, ORDER, STEPS = "codeqwen15_7b", 8, 12, 2
OPT = dict(peak_lr=4e-3, warmup_steps=2, total_steps=40)
LOSS_TOL, MOMENT_TOL, SCHEDULE_TOL = 1e-5, 1e-5, 1e-5
REPO = Path(__file__).resolve().parents[1]


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


@pytest.fixture(scope="module")
def setup():
    cfg = treg.get_smoke(ARCH)
    params, _ = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 16, 16, device="cpu")
    return cfg, params, [pipe.batch_at(s) for s in range(STEPS)]


def _par(cls, **kw):
    base = dict(attn_impl="naive", remat="none", grad_sync="gossip", gossip_order=ORDER,
                fsdp=False)
    return cls(**{**base, **kw})


def _reference_step(kind: str, par, optc):
    """The reference's ``shard_map`` local step (``repro/train/trainer.py``),
    composed from its own pieces and run per rank under ``vmap``."""
    cfg = jreg.get_smoke(ARCH)

    def loss_fn(p, b):
        loss, _ = jlm.loss_fn(p, b, cfg, par)
        return loss, {}

    def sync_leaves(tree, salt):
        return jgossip.chebyshev_gossip_mean(tree, "data", P, order=ORDER,
                                             payload_dtype=par.gossip_payload_dtype,
                                             truncate=par.gossip_truncate)

    def sync_bucketed(tree, salt):
        plan = jbuckets.build_bucket_plan(tree, par.gossip_buckets)
        flats = jbuckets.pack_buckets(plan, tree)
        outs = [jgossip.chebyshev_gossip_mean(f, "data", P, order=ORDER,
                                              payload_dtype=par.gossip_payload_dtype,
                                              truncate=par.gossip_truncate,
                                              delay_messages=2 * len(flats)) for f in flats]
        return jbuckets.unpack_buckets(plan, outs)

    sync = sync_bucketed if par.gossip_buckets > 1 else sync_leaves

    def local_step(params, opt, batch):
        if kind == "gossip" and par.gossip_overlap:
            loss, _, grads = jtrainer._accumulate_grads_overlap(
                loss_fn, params, batch, par.microbatches, sync)
        else:
            loss, _, grads = jtrainer._accumulate_grads(loss_fn, params, batch, par.microbatches)
            if kind == "gossip":
                grads = sync(grads, jnp.int32(0))
            elif kind == "barrier":
                grads = jax.tree.map(lambda g: jax.lax.pmean(g, "data"), grads)
        params, opt, om = jadamw_update(params, grads, opt, optc)
        return params, opt, {"loss": jax.lax.pmean(loss, "data"), **om}

    return jax.jit(jax.vmap(local_step, axis_name="data"))


def _rows(batch):
    return {k: jnp.asarray(v.numpy().reshape((P, -1) + tuple(v.shape[1:])))
            for k, v in batch.items()}


def _compare(port_step, ref_step, setup, moment_tol=MOMENT_TOL, steps=STEPS):
    cfg, params, batches = setup
    optc, joptc = AdamWConfig(**OPT), JAdamWConfig(**OPT)
    p, o = replicate(params, P), replicate(init_opt_state(params, optc), P)
    jp = jax.tree.map(_jnp_copy, interop.cache_to_numpy(p))
    jo = jax.tree.map(_jnp_copy, interop.cache_to_numpy(o))
    lr_sum, losses = 0.0, []
    for k, batch in enumerate(batches[:steps]):
        p, o, m = port_step(p, o, batch)
        jp, jo, jm = ref_step(jp, jo, _rows(batch))
        lr_sum += float(jm["lr"][0])
        assert float(m["loss"]) == pytest.approx(float(jm["loss"][0]), abs=LOSS_TOL)
        losses.append(float(m["loss"]))
        for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
            assert float((a - torch.from_numpy(np.array(b))).abs().max()) <= 2 * lr_sum + 1e-6
        if k == 0:
            for a, b in zip(tree_leaves(o["m"]), jax.tree.leaves(jo["m"])):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=moment_tol * np.abs(b).max() + 1e-12)
    return losses


_GOSSIP = {
    "serial": dict(gossip_buckets=1, gossip_overlap=False),
    "bucketed": dict(gossip_buckets=4, gossip_overlap=True),
    "delay-slot": dict(gossip_buckets=4, gossip_overlap=True, microbatches=2),
    "bf16-payload": dict(gossip_buckets=4, gossip_overlap=True, gossip_payload_dtype="bfloat16"),
}


@pytest.mark.parametrize("schedule", list(_GOSSIP))
def test_gossip_step_matches_reference(schedule, setup):
    cfg = setup[0]
    mesh = StackedMesh(P, "cpu")
    port = jit_train_step(make_gossip_train_step(
        cfg, _par(TPar, **_GOSSIP[schedule]), AdamWConfig(**OPT), None, mesh))
    # bf16 payloads: the two packages round slightly different f32 values
    # to bf16, so one-ulp flips move the synced grads within the
    # reference's own envelope, payload_roundoff_bound(M) of their scale;
    # they also flip the sign of some tiny synced entries, each of which
    # costs 2 lr at step 1 and so moves step 2's loss by ~1e-4: one step
    bf16 = "bf16" in schedule
    _compare(port, _reference_step("gossip", _par(JPar, **_GOSSIP[schedule]),
                                   JAdamWConfig(**OPT)), setup,
             moment_tol=jgossip.payload_roundoff_bound(ORDER) if bf16 else MOMENT_TOL,
             steps=1 if bf16 else STEPS)
    assert mesh.calls["ring"] > 0


@pytest.mark.parametrize("kind", ["barrier", "local_sgd"])
def test_barrier_and_local_sgd_steps_match_reference(kind, setup):
    cfg, params, batches = setup
    mesh = StackedMesh(P, "cpu")
    par = TPar(attn_impl="naive", remat="none")
    if kind == "barrier":
        port = make_barrier_train_step(cfg, par, AdamWConfig(**OPT), None, mesh)
    else:
        port, resync = make_local_sgd_train_step(cfg, par, AdamWConfig(**OPT), None, mesh)
    _compare(jit_train_step(port), _reference_step(
        kind, JPar(attn_impl="naive", remat="none"), JAdamWConfig(**OPT)), setup)
    if kind == "local_sgd":
        p = replicate(params, P)
        p = {**p, "final_norm": {"w": p["final_norm"]["w"]
                                 * torch.arange(1, P + 1.0).reshape(P, 1)}}
        want = jax.vmap(lambda t: jax.lax.pmean(t, "data"), axis_name="data")(
            jnp.asarray(p["final_norm"]["w"].numpy()))
        got = resync(p)["final_norm"]["w"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert torch.allclose(got[0], got[-1])


def test_port_schedules_agree_and_hooks_count(setup):
    # tests/test_elastic_and_gossip.py::test_gossip_schedule_parity_and_error_models
    cfg, params, batches = setup
    optc = AdamWConfig(**OPT)

    def run(**kw):
        step = jit_train_step(make_gossip_train_step(cfg, _par(TPar, **kw), optc, None,
                                                     StackedMesh(P, "cpu")))
        p, o = replicate(params, P), replicate(init_opt_state(params, optc), P)
        losses = []
        for b in batches:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        return np.asarray(losses)

    serial = run(gossip_buckets=1, gossip_overlap=False)
    assert np.abs(run(gossip_buckets=4, gossip_overlap=True) - serial).max() < SCHEDULE_TOL
    serial_mb2 = run(gossip_buckets=4, gossip_overlap=False, microbatches=2)
    delay = run(gossip_buckets=4, gossip_overlap=True, microbatches=2)
    assert np.abs(delay - serial_mb2).max() < SCHEDULE_TOL
    inj = StragglerInjector(alpha_ms=0.0)
    mesh = StackedMesh(P, "cpu")
    step = jit_train_step(make_gossip_train_step(
        cfg, _par(TPar, gossip_buckets=4, gossip_overlap=True), optc, None, mesh,
        round_delay=inj.gossip_round))
    p, o = replicate(params, P), replicate(init_opt_state(params, optc), P)
    for b in batches:
        p, o, _ = step(p, o, b)
    assert inj.rounds_injected == STEPS * P * ORDER
    barrier = StragglerInjector(alpha_ms=0.0)
    step = make_barrier_train_step(cfg, TPar(attn_impl="naive", remat="none"), optc, None,
                                   mesh, barrier_delay=barrier.allreduce_barrier)
    step(p, o, batches[0])
    assert barrier.rounds_injected == P


_SHARD_MAP_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.core import compat
from repro.configs import registry as jreg
from repro.models.config import ParallelConfig as JPar
from repro.optim import AdamWConfig as JAdamWConfig, init_opt_state as jinit
from repro.train import make_gossip_train_step as jmake
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.core.collectives import StackedMesh
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models import lm as tlm
from repro_torch.models.config import ParallelConfig as TPar
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import HOST_REPLICA, make_gossip_train_step, replica, replicate
from repro_torch.tree import tree_leaves

OPT = dict(peak_lr=4e-3, warmup_steps=2, total_steps=40)
KW = dict(attn_impl="naive", remat="none", grad_sync="gossip", gossip_order=4,
          gossip_buckets=4, gossip_overlap=True, fsdp=False)
cfg = treg.get_smoke("codeqwen15_7b")
params, _ = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
pipe = SyntheticTokenPipeline(cfg.vocab_size, 16, 16, device="cpu")
mesh = compat.make_mesh((8,), ("data",))
jstep = jax.jit(jmake(jreg.get_smoke("codeqwen15_7b"), JPar(**KW), JAdamWConfig(**OPT), None,
                      mesh))
jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)), interop.cache_to_numpy(params))
jo = jinit(jp, JAdamWConfig(**OPT))
step = make_gossip_train_step(cfg, TPar(**KW), AdamWConfig(**OPT), None, StackedMesh(8, "cpu"))
p, o = replicate(params, 8), replicate(init_opt_state(params, AdamWConfig(**OPT)), 8)
lr_sum = 0.0
with mesh:
    for s in range(3):
        b = pipe.batch_at(s)
        jb = jax.device_put({k: jnp.asarray(v.numpy()) for k, v in b.items()},
                            NamedSharding(mesh, PS("data")))
        jp, jo, jm = jstep(jp, jo, jb)
        p, o, m = step(p, o, b, donate=True)
        lr_sum += float(jm["lr"])
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5, (float(m["loss"]), float(jm["loss"]))
# The replicas drift (order 4 on 8 ranks is far from exact consensus), so
# the host read names one of them.
leaf = jax.tree.leaves(jp)[0]
host = np.asarray(leaf)
shards = sorted(leaf.addressable_shards, key=lambda sh: sh.device.id)
match = [i for i, sh in enumerate(shards) if np.array_equal(np.asarray(sh.data), host)]
distinct = len({np.asarray(sh.data).tobytes() for sh in shards})
print("HOST_READ", match, distinct)
assert distinct > 1 and match == [HOST_REPLICA], (match, distinct)
# the port's host replica is the reference's host read, within 2 lr per step
for a, b in zip(tree_leaves(replica(p, HOST_REPLICA)), jax.tree.leaves(jp)):
    assert float((a - torch.from_numpy(np.array(b))).abs().max()) <= 2 * lr_sum + 1e-6
print("OK")
"""


def test_reference_shard_map_step_and_its_host_replica():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", _SHARD_MAP_SCRIPT], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "OK" in proc.stdout
