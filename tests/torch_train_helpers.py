"""Shared pieces of the training-path parity tests
(``tests/test_torch_train*.py``): configs of both packages, a numpy
batch, JAX's loss and gradients, the port's, and the tolerance checks."""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import get_model
from repro_torch.train.train_step import loss_and_grad
from repro_torch.weights import params_from_jax, params_to_jax

FAMILIES = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "paligemma-3b",
            "recurrentgemma-9b", "seamless-m4t-medium", "mamba2-2.7b")
#: text tokens per row; the chunked head loss runs 2 chunks of CE_CHUNK
T_TEXT, CE_CHUNK = 32, 16
#: the hybrid's window, cut below T_TEXT so the local mask bites
HYBRID_WINDOW = 16


def configs(name: str):
    """(JAX config, port config) of ``name``'s smoke reduction."""
    jcfg, cfg = j_reduce(j_get_config(name)), reduce_for_smoke(
        get_config(name))
    if cfg.family == "hybrid":
        jcfg = dataclasses.replace(jcfg, window=HYBRID_WINDOW)
        cfg = dataclasses.replace(cfg, window=HYBRID_WINDOW)
    return jcfg, cfg


def batch_np(cfg, batch: int = 2, seed: int = 0, step: int = 0) -> dict:
    """A numpy batch of ``T_TEXT`` text tokens a row (+1), from the port's
    data pipeline (its tokens are JAX's)."""
    seq = T_TEXT + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    ds = SyntheticLMDataset(cfg, global_batch=batch, seq_len=seq, seed=seed)
    return ds.local_batch_np(step)


def jax_params(jcfg, seed: int = 0):
    return j_get_model(jcfg).init(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def jax_ref(name: str, ce_chunk: int):
    """JAX's params, batch and (loss, metrics, grads) on ``name``'s smoke
    config: remat "none" for the single-shot head, "block" for the
    chunked one (one jit each; cached for the process)."""
    jcfg, cfg = configs(name)
    jp = (jax_ref(name, 0)[0] if ce_chunk else jax_params(jcfg))
    batch = batch_np(cfg)
    remat = "block" if ce_chunk else "none"
    return jp, batch, jax_loss_and_grad(jcfg, jp, batch, remat, ce_chunk)


def check_family(name: str, remat: str, ce_chunk: int) -> dict:
    """The port's loss, metrics and grads held to JAX's run with the same
    ``ce_chunk`` (the tolerances below); returns the port's metrics."""
    _, cfg = configs(name)
    jp, batch, (jloss, jmet, jgrads) = jax_ref(name, ce_chunk)
    loss, met, grads = port_loss_and_grad(cfg, jp, batch, remat, ce_chunk)
    assert sorted(met) == sorted(jmet)
    assert_loss_close(loss, jloss, "loss")
    for k in jmet:
        assert_loss_close(met[k], jmet[k], k)
    assert_grads_close(grads, jgrads)
    return met


def check_round_trip(name: str) -> None:
    """params_to_jax(params_from_jax(p, dtype=float32)) == p, bit for bit,
    every leaf of JAX's tree."""
    _, cfg = configs(name)
    jp = to_np(jax_ref(name, 0)[0])
    back = params_to_jax(params_from_jax(jp, cfg, device="cpu",
                                         dtype=torch.float32), cfg)
    fa = jax.tree_util.tree_flatten_with_path(jp)[0]
    fb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def jax_loss_and_grad(jcfg, jp, batch: dict, remat: str, ce_chunk: int):
    """JAX's (loss, metrics, grads) as numpy, one jit."""
    model = j_get_model(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, remat=remat, ce_chunk=ce_chunk),
        has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, to_np(
        grads)


def port_loss_and_grad(cfg, jp, batch: dict, remat: str, ce_chunk: int):
    """The port's (loss, metrics, grads in JAX's layout) from JAX's params
    carried over as fp32 masters."""
    params = params_from_jax(to_np(jp), cfg, device="cpu",
                             dtype=torch.float32)
    loss, metrics, grads = loss_and_grad(
        get_model(cfg), params, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
        remat, ce_chunk)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        params_to_jax(grads, cfg)


def assert_loss_close(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (what, got, want)


def assert_grads_close(got, want) -> None:
    """Every leaf within rtol 1e-4, atol 1e-4 max|g_leaf| + 1e-7, and
    every leaf that JAX gives a gradient has one here."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, g), (_, w) in zip(fg, fw):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()) + 1e-7,
            err_msg=name)
        if np.any(w != 0):
            assert np.any(g != 0), f"{name}: no gradient"
