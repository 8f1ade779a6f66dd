"""Port parity: AdamW and the LR schedules (``repro_torch/optim``)
against JAX's ``repro/optim``.

* ``adamw_update`` on the same numpy params, grads and state (a step 3
  state, clipping active and not): params, m and v within 1e-6,
  ``grad_norm`` within 1e-6 relative, ``step`` equal.
* Weight decay, pinned: JAX decays a leaf when ``p.ndim >= 2`` on its
  layer-stacked tree, so every per-layer leaf decays (norm gains, biases,
  the RG-LRU and Mamba-2 vectors) and of the top-level leaves only the
  matrices (not ``final_norm`` / ``enc_norm``). With zero grads and
  moments the update is the decay alone: the port changes exactly the
  leaves JAX changes, by JAX's amounts (ROADMAP §3, "Found in the
  reference").
* ``cosine_schedule`` and ``linear_warmup`` equal JAX's within 1e-7 over
  steps 0 ... total + 5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_train_helpers as H  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.optim import (AdamWState, adamw_update, cosine_schedule,  # noqa: E402
                               decay_mask, global_norm, linear_warmup)
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402


def _random_tree(jcfg, rng, scale=1.0, positive=False):
    """numpy arrays on JAX's param tree of ``jcfg`` (shapes from
    ``jax.eval_shape``: no JAX init)."""
    shapes = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))

    def draw(s):
        x = rng.standard_normal(s.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return jax.tree_util.tree_map(draw, shapes)


def _port(tree, cfg):
    return params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)


def _assert_tree_close(got, want, atol, rtol=0.0):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, g), (_, w) in zip(fg, fw):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_adamw_update_matches_jax(name, grad_scale):
    jcfg, cfg = H.configs(name)
    rng = np.random.default_rng(0)
    p, g = _random_tree(jcfg, rng), _random_tree(jcfg, rng, grad_scale)
    m = _random_tree(jcfg, rng, 1e-2)
    v = _random_tree(jcfg, rng, 1e-4, positive=True)
    lr = np.float32(3e-3)
    jp, jst, jm = jax.jit(lambda p, g, s: jadamw.adamw_update(
        p, g, s, lr))(p, g, jadamw.AdamWState(jnp.int32(3), m, v))
    tp, tst, tm = adamw_update(
        _port(p, cfg), _port(g, cfg),
        AdamWState(torch.tensor(3, dtype=torch.int32), _port(m, cfg),
                   _port(v, cfg)), torch.tensor(lr))
    assert int(tst.step) == int(jst.step) == 4
    assert tst.step.dtype == torch.int32
    _assert_tree_close(params_to_jax(tp, cfg), jp, 1e-6)
    _assert_tree_close(params_to_jax(tst.m, cfg), jst.m, 1e-6)
    _assert_tree_close(params_to_jax(tst.v, cfg), jst.v, 1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(
        float(global_norm(_port(g, cfg))),
        float(jadamw.global_norm(g)), rtol=1e-6)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "seamless-m4t-medium", "mamba2-2.7b"])
def test_weight_decay_hits_the_leaves_jax_decays(name):
    jcfg, cfg = H.configs(name)
    rng = np.random.default_rng(1)
    p = _random_tree(jcfg, rng)
    zeros = jax.tree_util.tree_map(np.zeros_like, p)
    lr = np.float32(0.5)
    jp, _, _ = jax.jit(lambda p, z: jadamw.adamw_update(
        p, z, jadamw.AdamWState(jnp.int32(0), z, z), lr))(p, zeros)
    zp = _port(zeros, cfg)
    tp, _, _ = adamw_update(_port(p, cfg), zp,
                            AdamWState(torch.tensor(0, dtype=torch.int32),
                                       zp, _port(zeros, cfg)),
                            torch.tensor(lr))
    back = params_to_jax(tp, cfg)
    fj = jax.tree_util.tree_flatten_with_path(jp)[0]
    fp = jax.tree_util.tree_flatten_with_path(back)[0]
    fo = jax.tree_util.tree_leaves(p)
    decayed = set()
    for (path, a), (_, b), orig in zip(fj, fp, fo):
        name_ = jax.tree_util.keystr(path)
        moved_j = not np.array_equal(np.asarray(a), orig)
        assert moved_j == (not np.array_equal(b, orig)), name_
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6,
                                   err_msg=name_)
        if moved_j:
            decayed.add(name_)
    top = {"['final_norm']", "['enc_norm']"}
    # every leaf but the top-level norms decays
    want = {jax.tree_util.keystr(pa) for pa, _ in fj} - top
    assert decayed == want


def test_decay_mask_follows_the_stacked_layout():
    _, cfg = H.configs("seamless-m4t-medium")
    from repro_torch.weights import init_params
    mask = decay_mask(init_params(cfg, device="cpu"))
    assert mask["embed"] and mask["lm_head"] and mask["frontend_proj"]
    assert not mask["final_norm"] and not mask["enc_norm"]
    for lp in mask["enc_layers"] + mask["dec_layers"]:
        assert lp["ln1"] and lp["ln2"] and lp["attn"]["wq"]


@pytest.mark.parametrize("warmup,total", [(5, 40), (0, 10), (30, 12)])
def test_schedules_match_jax(warmup, total):
    for s in range(total + 6):
        for peak in (3e-4, 1e-3):
            want = float(jsched.cosine_schedule(s, peak, warmup, total))
            got = cosine_schedule(s, peak, warmup, total)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-7, (s, peak)
            got_t = cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                    peak, warmup, total)
            assert float(got_t) == float(got)
            assert abs(float(linear_warmup(s, peak, warmup))
                       - float(jsched.linear_warmup(s, peak, warmup))) <= 1e-7
