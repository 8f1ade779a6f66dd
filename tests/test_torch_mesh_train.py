"""Sharded training, ``make_train_step(mesh=)`` (FSDP over ``data`` x
tensor parallelism over ``model``), across processes on the CPU, held to
JAX's meshless ``make_train_step`` and to the port's meshless step: the
dense and MoE families.

Gloo worlds of 2 and 4 processes are spawned once for this module
(``tests/torch_mesh_worker.py``, jobs of kind ``"train"``) while JAX's
references run here (``tests/torch_mesh_train_helpers.py`` holds the
cases' settings and tolerances): smoke tinyllama (2 KV heads, split over
``model``) and the smoke MoE (experts and shared experts split over
``model``, q/k/v biases, its Switch aux loss reduced over the global
batch) on meshes (2, 1) and (1, 2) (world 2) and (2, 2) (world 4), three
steps each: per step the metrics and the gathered gradients equal JAX's,
the sharded AdamW is the meshless update, the params after three steps
JAX's; the same against the port's meshless run; microbatches 2 (each
holding JAX's rows, the rank its data block of them) for both under
(2, 1) and for tinyllama under (1, 2); each rank's state
bytes exactly its blocks of JAX's ``train_state_pspecs``, a layer-axis
block among them.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_mesh_train_helpers as M  # noqa: E402

NAMES = ("tinyllama-1.1b", "qwen2-moe-a2.7b")
WORLDS = {
    2: ([(n, s, 1) for s in ((2, 1), (1, 2)) for n in NAMES]
        + [(n, (2, 1), 2) for n in NAMES] + [("tinyllama-1.1b", (1, 2), 2)],
        [(2, 1), (1, 2)]),
    4: ([(n, (2, 2), 1) for n in NAMES], [(2, 2)])}
ONE = [(w, c) for w, (cs, _) in WORLDS.items() for c in cs if c[2] == 1]
MB = [(w, c) for w, (cs, _) in WORLDS.items() for c in cs if c[2] > 1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run_worlds(tmp_path_factory, WORLDS, NAMES)


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


@pytest.mark.parametrize("world,key", MB, ids=map(M.case_id, MB))
def test_microbatches_under_a_mesh(runs, world, key,
        record_property):
    """Microbatches 2 against the port's meshless step with microbatches
    2: each microbatch holds JAX's rows, so the MoE's Switch aux loss,
    whose means depend on which rows share a microbatch, is the meshless
    one under a data split too."""
    record_property("params_past_1e-6",
                    M.check_against_meshless(runs, world, key))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_rank_state_bytes_are_its_spec_blocks(runs, world):
    M.check_state_bytes(runs, world)


def test_a_layer_axis_block_is_held(runs):
    """On (2, 1) the MoE's ``bq`` (L, q_dim) is split over its layer axis
    (TP took its last axis, FSDP the largest left): each rank holds one
    of the two layers, and its params gather to JAX's layout."""
    for rank in range(2):
        got = M.case(runs, 2, ("qwen2-moe-a2.7b", (2, 1), 1), rank)
        assert got["blocks"]["layers::attn::bq"] == (1, 128)
