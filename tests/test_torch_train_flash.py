"""Port parity: the training path's differentiable flash attention
(``repro_torch/core/attention.py::flash_attention``, a
``torch.autograd.Function``) against JAX's ``flash_attention`` and its
``jax.custom_vjp``.

* Forward and dq/dk/dv equal JAX's (``jax.grad``) in the ``causal``,
  ``prefix``, ``local`` and ``full`` (Tq != Tk, cross-attention) modes,
  at 1, 2 and 4 query heads per KV head, at a T that is no multiple of
  the backward's chunk; atol = rtol = 1e-5 in fp32. On CPU tensors the
  forward is the flash-prefill kernel's plain version with the
  log-sum-exp (``flash_forward``), the backward ``flash_backward``.
* The forward's log-sum-exp equals logsumexp of the masked scores.
* The saved tensors hold no (Tq, Tk) array (the port of
  ``tests/test_attention.py::test_memory_scaling_structure``).
* The serving wrapper keeps its bits: ``flash_prefill`` without
  ``return_lse`` is the reference attention, as before."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as jatt  # noqa: E402
from repro_torch.core import attention as att  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 16
# (mode, Tq, Tk, window): T 40 is no multiple of the chunk
MODES = {"causal": (40, 40, 0), "prefix": (40, 40, 0),
         "local": (40, 40, 12), "full": (24, 40, 0)}


def _inputs(mode, qpk, seed=0):
    tq, tk, window = MODES[mode]
    hkv, b, d = 2, 2, 16
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, hkv * qpk, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
        (b, hkv * qpk, tq, d)))
    pl = np.array([7, 23], np.int32) if mode == "prefix" else None
    return q, k, v, g, pl, window


@pytest.mark.parametrize("qpk", [1, 2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_and_grads_match_jax(mode, qpk):
    q, k, v, g, pl, window = _inputs(mode, qpk)
    kw = dict(mode=mode, window=window, chunk=CHUNK)

    def jloss(q, k, v):
        out = jatt.flash_attention(q, k, v, prefix_len=None if pl is None
                                   else jnp.asarray(pl), **kw)
        return jnp.sum(out * g), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = att.flash_attention(tq, tk, tv, prefix_len=None if pl is None
                              else torch.from_numpy(pl), **kw)
    torch.testing.assert_close(out.detach(), torch.from_numpy(
        np.array(jout)), **TOL)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)),
                                (tq, tk, tv))
    for got, want in zip(grads, jgrads):
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                                   **TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lse_is_logsumexp_of_masked_scores(mode):
    q, k, v, _, pl, window = _inputs(mode, 2, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plt = None if pl is None else torch.from_numpy(pl)
    out, lse = fpk.flash_prefill(tq, tk, tv, mode=mode, window=window,
                                 prefix_len=plt, return_lse=True)
    scale = q.shape[-1] ** -0.5
    kk = tk.repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", tq * scale, kk)
    bias = att._mask_bias(mode, window, q.shape[2], k.shape[2], k.shape[2],
                          plt, "cpu")
    s = s + (bias[:, None] if bias.dim() == 3 else bias)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), **TOL)
    torch.testing.assert_close(out, att.reference_attention(
        tq, tk, tv, mode=mode, window=window, prefix_len=plt), **TOL)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]


def test_saved_tensors_hold_no_score_matrix():
    """Only (q, k, v, prefix_len, out, lse) are saved: nothing (Tq, Tk)."""
    t = 128
    q = torch.randn(1, 2, t, 16, requires_grad=True)
    k = torch.randn(1, 2, t, 16, requires_grad=True)
    v = torch.randn(1, 2, t, 16, requires_grad=True)
    shapes = []

    def pack(x):
        shapes.append(tuple(x.shape))
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = att.flash_attention(q, k, v, chunk=32)
    torch.sum(out).backward()
    assert shapes, "nothing was saved"
    for s in shapes:
        assert not (len(s) >= 2 and s[-1] == t and s[-2] == t), s
    assert max(int(np.prod(s)) for s in shapes) <= 2 * t * 16


def test_serving_call_keeps_the_reference_bits():
    q, k, v, _, _, _ = _inputs("causal", 2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fpk.flash_prefill(tq, tk, tv)
    assert torch.equal(got, att.reference_attention(tq, tk, tv))


def test_no_grad_inputs_take_the_forward_only_call():
    """``attention_train`` reaches the differentiable function only for
    inputs that need a gradient (the training loss); the serving entries
    run under ``torch.no_grad`` and keep the forward-only kernel call."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import attn_block as AB
    from repro_torch.weights import init_params
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    p = init_params(cfg, device="cpu")["layers"][0]["attn"]
    x = torch.randn(1, 8, cfg.d_model)
    calls = []
    real = fpk.flash_prefill

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)
    with mock.patch.object(fpk, "flash_prefill", spy):
        with torch.no_grad():
            AB.attention_train(p, x, cfg)
        AB.attention_train({n: w.requires_grad_(True) for n, w in p.items()},
                           x, cfg).sum().backward()
    assert calls == [False, True]
