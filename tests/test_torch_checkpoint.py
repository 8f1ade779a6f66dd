"""The port's checkpoints (``repro_torch/checkpoint``; port of
``tests/test_checkpoint.py``) and their format, which is JAX's.

* Round trip, a torn checkpoint (no manifest) invisible, retention,
  the manifest's shapes and dtypes, under JAX's leaf paths.
* Cross-package: JAX's ``save_checkpoint`` of a JAX ``TrainState``
  restores in the port onto the port state's JAX layout, and gives
  ``params_from_jax(..., dtype=float32)`` of JAX's params bit for bit
  (moments and step too); a port save restores in JAX equal to
  ``params_to_jax`` of the port's state. On the dense and hybrid smoke
  configs (the hybrid's layers split back into its period and tail
  stacks)."""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_train_helpers as H  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.train.train_step import (train_state_from_jax,  # noqa: E402
                                          train_state_to_jax)
from repro_torch.weights import params_from_jax  # noqa: E402


class _Pair(NamedTuple):
    a: torch.Tensor
    nested: dict


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return _Pair(a=torch.randn((8, 16), generator=g),
                 nested={"b": torch.arange(10, dtype=torch.int32),
                         "c": np.float32(3.5)})


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"step": 7})
    assert latest_step(str(tmp_path)) == 7
    restored, extra = restore_checkpoint(str(tmp_path), 7, t)
    assert extra == {"step": 7}
    assert isinstance(restored, _Pair)
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_torn_checkpoint_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_0000000009")
    (tmp_path / "step_0000000009" / "shards-00000.npz").write_bytes(b"junk")
    assert latest_step(str(tmp_path)) == 3


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(steps) == 2
    assert latest_step(str(tmp_path)) == 4


def test_manifest_records_shapes_under_jax_paths(tmp_path):
    p = save_checkpoint(str(tmp_path), 1, _tree())
    with open(os.path.join(p, "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"][".a"]["shape"] == [8, 16]
    assert man["leaves"][".nested::b"]["dtype"] == "int32"
    assert man["leaves"][".nested::c"]["shape"] == []
    with np.load(os.path.join(p, "shards-00000.npz")) as z:
        assert sorted(z.files) == [".a@0,0", ".nested::b@0", ".nested::c@"]


def _jax_state(jcfg):
    """A JAX TrainState with moments and step that are not zero."""
    st = jts.init_train_state(j_get_model(jcfg), jax.random.PRNGKey(0))
    m = jax.tree_util.tree_map(lambda p: p * 0.5, st.params)
    v = jax.tree_util.tree_map(lambda p: p * p, st.params)
    return jts.TrainState(st.params, st.opt._replace(step=jnp.int32(7), m=m,
                                                     v=v))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_jax_checkpoint_restores_in_the_port(name, tmp_path):
    jcfg, cfg = H.configs(name)
    jstate = _jax_state(jcfg)
    jck.save_checkpoint(str(tmp_path), 7, jstate, extra={"data_step": 7})
    template = train_state_to_jax(
        init_train_state(get_model(cfg), 0, device="cpu"), cfg)
    np_state, extra = restore_checkpoint(str(tmp_path), 7, template)
    assert extra == {"data_step": 7}
    state = train_state_from_jax(np_state, cfg, device="cpu")
    assert int(state.opt.step) == 7
    js = H.to_np(jstate)
    for got, want in ((state.params, js.params), (state.opt.m, js.opt.m),
                      (state.opt.v, js.opt.v)):
        ref = params_from_jax(want, cfg, device="cpu", dtype=torch.float32)
        for a, b in zip(tree_leaves(got), tree_leaves(ref)):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_port_checkpoint_restores_in_jax(name, tmp_path):
    jcfg, cfg = H.configs(name)
    state = init_train_state(get_model(cfg), 5, device="cpu")
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(4, dtype=torch.int32), m=state.params))
    save_checkpoint(str(tmp_path), 4, train_state_to_jax(state, cfg),
                    extra={"step": 4})
    shapes = jax.eval_shape(
        lambda k: jts.init_train_state(j_get_model(jcfg), k),
        jax.random.PRNGKey(0))
    jstate, extra = jck.restore_checkpoint(str(tmp_path), 4, shapes)
    assert extra == {"step": 4}
    want = train_state_to_jax(state, cfg)
    fa = jax.tree_util.tree_flatten_with_path(H.to_np(jstate))[0]
    fb = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
