"""Sharded training across processes on the CPU (as
``tests/test_torch_mesh_train.py``): the hybrid family FSDP-only, the
sharded checkpoints, ``Trainer(mesh=)`` and the launcher.

A gloo world of 2 runs smoke recurrentgemma (window 16) on (2, 1) —
three steps against JAX's meshless
``make_train_step`` and the port's meshless step —, then three tinyllama
steps on (2, 1) saved as a sharded checkpoint (one shard file a rank,
JAX's offsets), which JAX's ``restore_checkpoint`` reads whole and (1, 2)
restores into its blocks (elastic); JAX's own save restored onto (2, 1)
and (1, 2); and ``Trainer(mesh=)`` on (2, 1) resumed from its step-2
checkpoint, equal to an unbroken run bit for bit. Meanwhile
``python -m torch.distributed.run --nproc-per-node 2 -m
repro_torch.launch.train --smoke --mesh host --device cpu`` and the
meshless launcher run as subprocesses: the final losses agree within
1e-5 relative.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_mesh_train_helpers as M  # noqa: E402
import torch_train_helpers as H  # noqa: E402
from repro.checkpoint import checkpointing as jck  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamW  # noqa: E402
from repro.train import train_step as jts  # noqa: E402

NAMES = ("recurrentgemma-9b",)
WORLDS = {2: ([(n, (2, 1), 1) for n in NAMES], [(2, 1), (1, 2)])}
ONE = [(2, c) for c in WORLDS[2][0]]
LAUNCH = ["--smoke", "--steps", "4", "--batch", "4", "--seq", "32"]


def _jax_saved_state():
    """A JAX train state of smoke tinyllama with non-zero moments."""
    params = M.params_np("tinyllama-1.1b")
    rng = np.random.default_rng(5)
    noise = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    return jts.TrainState(params=params, opt=JAdamW(
        step=np.asarray(3, np.int32), m=noise,
        v=jax.tree_util.tree_map(np.abs, noise)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_state")
    jax_state = _jax_saved_state()
    jck.save_checkpoint(str(d / "jax_ckpt"), 3, jax_state, extra={"step": 3})
    launch = (M.launch_train(LAUNCH + ["--mesh", "host"], d / "mesh", True),
              M.launch_train(LAUNCH, d / "meshless", False))
    extra = {2: {"port_ckpt": str(d / "port_ckpt"),
                 "jax_ckpt": str(d / "jax_ckpt"),
                 "trainer_dir": str(d / "trainer"),
                 "ckpt_params": M.params_np("tinyllama-1.1b"),
                 "ckpt_batches": M.batches_np("tinyllama-1.1b")}}
    out = M.run_worlds(tmp_path_factory, WORLDS, NAMES, extra)
    outs = []
    for p in launch:
        text, _ = p.communicate(timeout=240)
        assert p.returncode == 0, text
        outs.append(text)
    return dict(out, launch=outs, jax_ckpt=jax_state)


@pytest.mark.parametrize("world,key", ONE, ids=map(M.case_id, ONE))
def test_sharded_steps_match_jax_meshless(runs, world, key,
        record_property):
    record_property("params_past_1e-6",
                    M.check_against_jax(runs, world, key))


@pytest.mark.parametrize("world,key", ONE, ids=map(M.case_id, ONE))
def test_sharded_steps_match_port_meshless(runs, world, key,
        record_property):
    record_property("params_past_1e-6",
                    M.check_against_meshless(runs, world, key))


def test_rank_state_bytes_are_its_spec_blocks(runs):
    M.check_state_bytes(runs, 2)


def _equal(a, b) -> bool:
    fa, fb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(fa) == len(fb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(fa, fb))


def test_sharded_checkpoint_read_by_jax(runs):
    """A (2, 1) save (a shard file a rank, JAX's offsets) read by JAX's
    ``restore_checkpoint`` equals the gathered state bit for bit, and
    equals ``train_state_to_jax`` of the state restored whole in the
    port."""
    ck = runs["worlds"][2][0]["ckpt"]
    jcfg, _ = H.configs("tinyllama-1.1b")
    jm = j_get_model(jcfg)
    shapes = jax.eval_shape(lambda k: jts.init_train_state(jm, k),
                            jax.random.PRNGKey(0))
    got, extra = jck.restore_checkpoint(ck["dir"], 3, shapes)
    assert extra == {"step": 3}
    assert _equal(H.to_np(got), ck["saved"])
    assert _equal(ck["whole"], ck["saved"])
    files = sorted(os.listdir(os.path.join(ck["dir"], "step_0000000003")))
    assert files == ["manifest.json", "shards-00000.npz", "shards-00001.npz"]


def test_elastic_restore_of_a_sharded_save(runs):
    """The (2, 1) save restored onto (1, 2) gathers to the saved state on
    every rank."""
    for res in runs["worlds"][2]:
        assert _equal(res["ckpt"]["elastic"], res["ckpt"]["saved"])
        assert res["ckpt"]["elastic_extra"] == {"step": 3}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_jax_checkpoint_restores_onto_a_mesh(runs, shape):
    for res in runs["worlds"][2]:
        assert _equal(res["ckpt"][("jax", shape)], runs["jax_ckpt"])


def test_resumed_trainer_equals_unbroken(runs):
    """``Trainer(mesh=)`` on (2, 1): two steps, then a new trainer
    restores their checkpoint into each rank's blocks and trains to four
    — the losses and the final state equal four unbroken steps bit for
    bit; only rank 0 logs."""
    for rank, res in enumerate(runs["worlds"][2]):
        tr = res["trainer"]
        a, b = tr["unbroken"], tr["resumed"]
        assert a["losses"] == b["losses"] and len(a["losses"]) == 4
        assert a["data_step"] == b["data_step"] == 4
        assert _equal(a["state"], b["state"])
        if rank == 0:
            assert "[trainer] restored step=2" in tr["logs"]
        else:
            assert tr["logs"] == []


def test_launch_train_mesh_host_matches_meshless(runs):
    """``--mesh host`` over two gloo ranks: one summary (rank 0's), the
    world named, the final loss the meshless launcher's within 1e-5
    relative."""
    mesh_out, plain_out = runs["launch"]

    def final(out):
        lines = [x for x in out.splitlines() if "done: final loss" in x]
        assert len(lines) == 1, out
        return float(lines[0].split("final loss ")[1].split()[0])
    assert "[train] mesh {'data': 2, 'model': 1} over gloo" in mesh_out
    a, b = final(mesh_out), final(plain_out)
    assert abs(a - b) <= 1e-5 * abs(b), (a, b)
