"""Sharded training across processes on the CPU (as
``tests/test_torch_mesh_train.py``): the VLM, encoder-decoder and SSM
families.

Smoke paligemma on (2, 1), (1, 2) (world 2) and (2, 2) (world 4): one KV
head, so every ``model`` rank projects it with the whole ``wk`` / ``wv``
(gathered over ``model``) and takes it for its query heads; the image
prefix under the prefix-LM mask; the head vocab-parallel. Smoke seamless
(encoder, decoder, cross-attention) and smoke mamba2 (tied embeddings,
no attention) FSDP-only on (2, 1). Three steps each against JAX's
meshless ``make_train_step`` and the port's meshless step; each rank's
state bytes its blocks of JAX's specs.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_mesh_train_helpers as M  # noqa: E402

NAMES = ("paligemma-3b", "seamless-m4t-medium", "mamba2-2.7b")
WORLDS = {
    2: ([("paligemma-3b", (2, 1), 1), ("paligemma-3b", (1, 2), 1),
         ("seamless-m4t-medium", (2, 1), 1), ("mamba2-2.7b", (2, 1), 1)],
        [(2, 1), (1, 2)]),
    4: ([("paligemma-3b", (2, 2), 1)], [(2, 2)])}
ONE = [(w, c) for w, (cs, _) in WORLDS.items() for c in cs]


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


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_rank_state_bytes_are_its_spec_blocks(runs, world):
    M.check_state_bytes(runs, world)
