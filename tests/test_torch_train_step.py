"""Port parity: the train step (``repro_torch/train/train_step.py``)
against JAX's ``make_train_step``.

* One and three steps, microbatches 1 and 4, from JAX's initial state
  (params and zero moments carried over as fp32) on JAX's batches: the
  loss trajectory within 1e-4 relative of JAX's, and ``ce``, ``aux``,
  ``lr`` and ``grad_norm`` with it; after three steps the AdamW step
  counts agree.
* Microbatch equivalence in the port itself: 4 microbatches give the
  params of one batch within JAX's own 5e-3
  (``tests/test_train.py::test_microbatch_equivalence``).
* ``init_train_state`` keeps fp32 masters (for a bf16 config too) and
  zero fp32 moments; the state's JAX layout round trips; a mesh is
  taken (sharded training: ``tests/test_torch_mesh_train*.py``) except
  ``model`` > 1 for the hybrid, encoder-decoder and SSM families, refused
  by name."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_train_helpers as H  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import StepConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.train_step import (train_state_from_jax,  # noqa: E402
                                          train_state_to_jax)

NAME = "tinyllama-1.1b"
STEP_CFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _batches(cfg, n=3, batch=8, seq=32):
    ds = SyntheticLMDataset(cfg, global_batch=batch, seq_len=seq, seed=1)
    return [ds.next_batch() for _ in range(n)]


@pytest.mark.parametrize("microbatches", [1, 4])
def test_three_steps_match_jax(microbatches):
    jcfg, cfg = H.configs(NAME)
    jm = j_get_model(jcfg)
    sc = dict(STEP_CFG, microbatches=microbatches)
    jstep = jts.make_train_step(jm, None, jts.StepConfig(**sc))
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    state = train_state_from_jax(H.to_np(jstate), cfg, device="cpu")
    step = make_train_step(get_model(cfg), None, StepConfig(**sc))
    for b in _batches(cfg):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        state, met = step(state, b)
        assert sorted(met) == sorted(jmet) == [
            "aux", "ce", "grad_norm", "loss", "lr"]
        for k in jmet:
            want = float(jmet[k])
            assert abs(float(met[k]) - want) <= 1e-4 * max(abs(want),
                                                           1e-6), k
    assert int(state.opt.step) == int(jstate.opt.step) == 3


def test_microbatch_equivalence():
    _, cfg = H.configs(NAME)
    b = _batches(cfg, 1)[0]
    out = {}
    for n in (1, 4):
        step = make_train_step(get_model(cfg), None,
                               StepConfig(peak_lr=1e-3, microbatches=n))
        out[n], _ = step(init_train_state(get_model(cfg), 0, device="cpu"),
                         b)
    for a, c in zip(tree_leaves(out[1].params), tree_leaves(out[4].params)):
        torch.testing.assert_close(a, c, atol=5e-3, rtol=5e-3)


def test_init_train_state_keeps_fp32_masters():
    _, cfg = H.configs(NAME)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    st = init_train_state(get_model(cfg), 3, device="cpu")
    assert all(p.dtype == torch.float32 for p in tree_leaves(st.params))
    assert all(float(m.abs().sum()) == 0 and m.dtype == torch.float32
               for m in tree_leaves(st.opt.m) + tree_leaves(st.opt.v))
    assert st.opt.step.dtype == torch.int32 and int(st.opt.step) == 0
    back = train_state_from_jax(train_state_to_jax(st, cfg), cfg,
                                device="cpu")
    for a, c in zip(tree_leaves(st), tree_leaves(back)):
        assert torch.equal(a, c)


def test_mesh_is_refused_by_name():
    """The refusals that remain under a mesh: tensor parallelism for the
    families ``models/transformer.py`` does not train, by name; a (1, 1)
    mesh is taken."""
    class Mesh:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")
        coords = {"data": 0, "model": 0}
    for name in ("recurrentgemma-9b", "seamless-m4t-medium", "mamba2-2.7b"):
        _, cfg = H.configs(name)
        with pytest.raises(ValueError, match=f"{cfg.family!r} family"):
            make_train_step(get_model(cfg), Mesh())
    from repro_torch.launch.mesh import make_mesh
    _, cfg = H.configs(NAME)
    step = make_train_step(get_model(cfg), make_mesh((1, 1),
                                                     ("data", "model")))
    assert step.state_specs.params["embed"] == ("data", None)
