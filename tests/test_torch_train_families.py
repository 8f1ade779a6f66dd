"""Port parity: the VLM (``models/transformer.py``: prefix-LM attention
over the projected patches, the patch rows dropped before the head) and
SSM (``models/ssm_lm.py``: the Mamba-2 mixer from the zero state)
families' training loss and gradients against JAX's, with the
tolerances and the four remat / ce_chunk arms of
``test_torch_train_loss.py``, and the weights' bit-exact round trip
through ``params_to_jax``."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import torch_train_helpers as H  # noqa: E402

NAMES = ("paligemma-3b", "mamba2-2.7b")


@pytest.mark.parametrize("ce_chunk", [0, H.CE_CHUNK])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads_match_jax(name, remat, ce_chunk):
    H.check_family(name, remat, ce_chunk)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip_bit_exact(name):
    H.check_round_trip(name)
