"""Port parity: every family's training loss and its gradients against
JAX's — the dense and MoE families here (``models/transformer.py``
``lm_loss``; the others in ``test_torch_train_families.py``,
``test_torch_train_hybrid.py`` and ``test_torch_train_encdec.py``).

On the smoke configs with JAX's params carried over as fp32 masters
(``params_from_jax(..., dtype=float32)``) and one numpy batch
(``tests/torch_train_helpers.py``): the loss within 1e-5 * max(1,
|loss|), each metric (``ce``, ``aux``) apart; every gradient leaf, mapped
through ``params_to_jax``, within rtol 1e-4 and atol 1e-4 * max|g_leaf| +
1e-7, and every leaf JAX gives a gradient has one (an attention output
without a ``grad_fn`` would leave wq/wk/wv none). Each of remat "none" /
"block" with ce_chunk 0 / 16 (T = 32: two chunks) is held to JAX's run
with the same ce_chunk. Also: the weights round trip
``params_to_jax(params_from_jax(p, dtype=float32)) == p`` bit for bit,
``params_from_jax`` keeps the model dtype unless told otherwise, and the
differentiable attention's forward runs once a layer without remat and
twice with block remat."""
import dataclasses
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import torch_train_helpers as H  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAMES = ("tinyllama-1.1b", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("ce_chunk", [0, H.CE_CHUNK])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads_match_jax(name, remat, ce_chunk):
    met = H.check_family(name, remat, ce_chunk)
    assert sorted(met) == ["aux", "ce"]
    assert (met["aux"] > 0) == (name == "qwen2-moe-a2.7b")


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip_bit_exact(name):
    H.check_round_trip(name)


def test_params_from_jax_keeps_the_model_dtype_by_default():
    _, cfg = H.configs("tinyllama-1.1b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jp = H.to_np(H.jax_ref("tinyllama-1.1b", 0)[0])
    p = params_from_jax(jp, cfg, device="cpu")
    assert p["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"][0]["ln1"].dtype == torch.float32
    p32 = params_from_jax(jp, cfg, device="cpu", dtype=torch.float32)
    assert p32["layers"][0]["attn"]["wq"].dtype == torch.float32


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("block", 2)])
def test_remat_reruns_the_attention_forward(remat, per_layer):
    """Block remat recomputes each layer in the backward, so the
    attention's forward (kernel #3 on the card) runs twice a layer."""
    _, cfg = H.configs("tinyllama-1.1b")
    jp, batch, _ = H.jax_ref("tinyllama-1.1b", 0)
    calls = []
    real = fpk.flash_prefill

    def spy(*a, **kw):
        calls.append(kw["return_lse"])
        return real(*a, **kw)
    with mock.patch.object(fpk, "flash_prefill", spy):
        H.port_loss_and_grad(cfg, jp, batch, remat, 0)
    assert calls == [True] * (per_layer * cfg.num_layers)
