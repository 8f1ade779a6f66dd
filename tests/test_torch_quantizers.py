"""Port parity: polar transform and polar key / value quantizers of
``repro_torch`` against the JAX package on shared numpy inputs.

Tolerances (as the JAX suite): polar codes exactly equal — except that an
element whose JAX pre-floor value ``(v - min) / s`` lies within 4 ulp of
an integer may sit one step away (an atan2/sqrt ulp of the other
library can move it across the floor); the stats, being mins and maxes
of rho/theta, agree to a few float32 ulps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import polar as jpolar  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro_torch.core import polar as tpolar  # noqa: E402
from repro_torch.core import quantizers as tq  # noqa: E402

STATS = ("rho_scale", "rho_zero", "theta_scale", "theta_zero")

# the JAX encode as the serving path runs it: jitted (the config is static)
_j_encode = jax.jit(jq.encode_polar_keys, static_argnums=1)


def _prefloor_ok(v, mn, s):
    """Within 4 ulp of an integer: |q - round(q)| <= 4 * spacing(q)."""
    q = (v - mn) / s
    return np.abs(q - np.round(q)) <= 4 * np.spacing(np.abs(q).astype(
        np.float32))


def check_encode(k: np.ndarray, group_size: int, r_bits=4, t_bits=4):
    """Encode ``k`` in both packages and hold the port to the JAX result."""
    jcfg = jq.QuantConfig(group_size=group_size, rho_bits=r_bits,
                          theta_bits=t_bits)
    tcfg = tq.QuantConfig(group_size=group_size, rho_bits=r_bits,
                          theta_bits=t_bits)
    jk = _j_encode(jnp.asarray(k), jcfg)
    tk = tq.encode_polar_keys(torch.from_numpy(k.copy()), tcfg)
    for name in STATS:
        np.testing.assert_allclose(getattr(tk, name).numpy(),
                                   np.asarray(getattr(jk, name)),
                                   rtol=1e-6, atol=1e-6)
    jc = np.asarray(jk.codes).astype(np.int32)
    tc = tk.codes.numpy().astype(np.int32)
    bad = jc != tc
    if bad.any():
        # pre-floor values of the JAX encode at the differing elements
        jr, jt = (np.asarray(x) for x in jpolar.to_polar(jnp.asarray(k)))
        g = group_size
        lead = k.shape[:-2]
        jr = jr.reshape(*lead, -1, g, jr.shape[-1])
        jt = jt.reshape(*lead, -1, g, jt.shape[-1])
        for shift, bits, v, s, z in (
                (t_bits, r_bits, jr, jk.rho_scale, jk.rho_zero),
                (0, t_bits, jt, jk.theta_scale, jk.theta_zero)):
            mask = (1 << bits) - 1
            a, b = (jc >> shift) & mask, (tc >> shift) & mask
            moved = a != b
            if not moved.any():
                continue
            assert np.abs(a - b)[moved].max() == 1
            near = _prefloor_ok(v, np.asarray(z), np.asarray(s))
            assert near[moved].all(), "a code flipped away from a boundary"
    return jk, tk


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 256, 64)).astype(np.float32)
    k[0, 0, :7, :5] = 0.0                           # zero pairs: theta pin
    k[0, 0, :7, 32:37] = 0.0
    k[1, 2, 3, :4] = np.float32(3e-39)              # denormals: the flush
    k[1, 2, 3, 32:36] = np.float32(3e-39)
    k[1, 2, 5, 8:12] = np.float32(-1e-40)
    k[1, 2, 5, 40:44] = np.float32(-1e-40)
    k[1, 0, 6, 1] = np.float32(2e-39)               # a lone denormal x

    k[0, 1, 9, 2] = -0.0                            # negative zero
    return k


def test_to_polar_matches_jax(keys):
    jr, jt = (np.asarray(x) for x in jpolar.to_polar(jnp.asarray(keys)))
    tr, tt = (x.numpy() for x in tpolar.to_polar(torch.from_numpy(keys)))
    # float32 sqrt/atan2 of the two libraries differ by a few ulps
    np.testing.assert_allclose(tr, jr, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=2e-6, atol=1e-6)
    # the pinned / flushed elements are exact
    assert (tt[0, 0, :7, :5] == np.float32(np.pi)).all()
    assert (tr[1, 2, 3, :4] == 0.0).all() and (tr[1, 2, 5, 8:12] == 0.0).all()
    assert (tt[1, 2, 3, :4] == np.float32(np.pi)).all()
    np.testing.assert_array_equal(tt[1, 2, 5, 8:12], jt[1, 2, 5, 8:12])
    np.testing.assert_array_equal(tt[1, 0, 6, 1], jt[1, 0, 6, 1])


@pytest.mark.parametrize("group_size", [32, 128])
@pytest.mark.parametrize("bits", [(4, 4), (3, 3), (5, 3)])
def test_encode_polar_keys_matches_jax(keys, group_size, bits):
    jk, tk = check_encode(keys, group_size, *bits)
    # decoding the same codes/stats gives the same keys
    pk = tq.PolarKeys(codes=torch.from_numpy(np.array(jk.codes)),
                      rho_bits=bits[0], theta_bits=bits[1],
                      **{n: torch.from_numpy(np.array(getattr(jk, n)))
                         for n in STATS})
    np.testing.assert_allclose(tq.decode_polar_keys(pk).numpy(),
                               np.asarray(jq.decode_polar_keys(jk)),
                               rtol=1e-5, atol=1e-5)


def test_encode_structured_and_bf16_keys(structured_keys):
    """The paper's key structure (RoPE'd outlier channels) and keys that
    went through bf16, as the cache's residual rounds them."""
    k = np.asarray(structured_keys(jax.random.PRNGKey(1), 2, 4, 256, 64))
    check_encode(k, 128)
    kb = np.array(jnp.asarray(k).astype(jnp.bfloat16).astype(jnp.float32))
    check_encode(kb, 32)
    # bf16 input tensors encode like their float32 upcast
    t_bf = tq.encode_polar_keys(torch.from_numpy(kb).to(torch.bfloat16),
                                tq.QuantConfig(group_size=32))
    t_32 = tq.encode_polar_keys(torch.from_numpy(kb),
                                tq.QuantConfig(group_size=32))
    assert torch.equal(t_bf.codes, t_32.codes)


def test_values_mid_tread_within_one_step():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((2, 3, 64, 32)).astype(np.float32)
    jv = jq.encode_values(jnp.asarray(v), 4)
    tv = tq.encode_values(torch.from_numpy(v), 4)
    np.testing.assert_allclose(tv.scale.numpy(), np.asarray(jv.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(tv.zero.numpy(), np.asarray(jv.zero),
                               rtol=1e-6)
    step = np.abs(tv.codes.numpy().astype(int) - np.asarray(jv.codes))
    assert step.max() <= 1
    np.testing.assert_allclose(
        tq.decode_values(tv).numpy(), np.asarray(jq.decode_values(jv)),
        atol=float(np.asarray(jv.scale).max()) + 1e-6)


def test_affine_encode_rejects_bad_group():
    with pytest.raises(ValueError, match="not divisible"):
        tq.encode_polar_keys(torch.zeros((1, 1, 10, 8)),
                             tq.QuantConfig(group_size=4))


def test_polar_codec_round_trip_matches_quantizers(keys):
    """The registered codec's encode/decode/init_buffers are the quantizer
    functions under the buffer-layout contract."""
    from repro_torch.core.codecs import get_codec
    cfg = tq.QuantConfig(group_size=32)
    codec = get_codec("polar")
    k = torch.from_numpy(keys)
    codes, scales = codec.encode(cfg, k)
    pk = tq.encode_polar_keys(k, cfg)
    assert torch.equal(codes, pk.codes)
    for name in STATS:
        assert torch.equal(scales[name], getattr(pk, name))
    np.testing.assert_array_equal(codec.decode(cfg, codes, scales).numpy(),
                                  tq.decode_polar_keys(pk).numpy())
    bc, bs = codec.init_buffers(cfg, (5, 3), 64, 64, torch.float32, "cpu")
    assert bc.shape == (5, 3, 2, 32, 32) and bc.dtype == torch.uint8
    assert all(v.shape == (5, 3, 2, 1, 32) for v in bs.values())
    with pytest.raises(KeyError, match="unknown key codec"):
        get_codec("kivi")
