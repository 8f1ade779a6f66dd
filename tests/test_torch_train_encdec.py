"""Port parity: the encoder-decoder family's (``models/encdec.py``: the
encoder over the frames, the decoder's causal self-attention and its
cross-attention over the memory, Tq != Tk) training loss and gradients
against JAX's, with the tolerances and the four remat / ce_chunk arms of
``test_torch_train_loss.py``, and the weights' bit-exact round trip
through ``params_to_jax``."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import torch_train_helpers as H  # noqa: E402

NAMES = ("seamless-m4t-medium",)


@pytest.mark.parametrize("ce_chunk", [0, H.CE_CHUNK])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads_match_jax(name, remat, ce_chunk):
    H.check_family(name, remat, ce_chunk)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip_bit_exact(name):
    H.check_round_trip(name)
