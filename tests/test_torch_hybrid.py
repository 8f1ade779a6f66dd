"""Port parity: the hybrid RG-LRU + local-attention family
(recurrentgemma, ``repro_torch/models/hybrid.py`` and ``rglru.py``) and the
ring KV cache it keeps (``repro_torch/core/kv_cache.py`` under a
``RingLayout``) against the JAX package.

* The ring cache at window 64, g 16: a prompt longer than the window and
  appends that wrap during decode leave JAX's buffers — codes equal,
  stats within 1e-6, values, residual and length exact — and
  ``decode_attention(window=)`` agrees within 1e-4.
* ``rglru_mix`` (with and without a carried state) and ``rglru_step``
  within 1e-5; a prefill of T then k steps equals a prefill of T + k, for
  the block and for the whole model on the fp cache.
* ``ServeEngine`` on the smoke recurrentgemma (one (rec, rec, attn)
  period plus a one-layer tail): greedy tokens identical to JAX's over 16
  steps, on both static decode routes (a windowed layer never reaches the
  fused kernel); prefill logits within 1e-4 and the state held to JAX's
  (ring codes equal, a bf16 residual key within one bf16 step — the
  standing finding of ROADMAP §3: keys that differ by float32 ulps can
  round to the other bf16 neighbour); then every decode step runs from
  JAX's state on both sides and its logits agree within 1e-4.
* The refusals: ``EngineCore`` on both static-only families, a per-layer
  cache policy on the hybrid."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import CachePolicy as JPolicy  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import kv_cache as jkv  # noqa: E402
from repro.core.cache_layout import RingLayout as JRing  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.serve import EngineCore as JCore  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import CachePolicy, QuantConfig  # noqa: E402
from repro_torch.core import kv_cache as tkv  # noqa: E402
from repro_torch.core.cache_layout import RingLayout  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hybrid as HY  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.serve import EngineCore  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "recurrentgemma-9b"
B, H, D, G, WIN = 2, 1, 32, 16, 64
TOL = dict(rtol=1e-4, atol=1e-4)

_j_prefill = jax.jit(jkv.prefill)
_j_append = jax.jit(jkv.append)
_j_decode = jax.jit(jkv.decode_attention, static_argnames="window")


def t(x):
    """numpy (or JAX) -> torch; bf16 arrays through float32 (exact)."""
    x = np.array(x)
    return torch.from_numpy(x.astype(np.float32) if x.dtype.name ==
                            "bfloat16" else x)


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

# (prompt, appends): a prompt past the window (the ring wraps at prefill,
# key groups from the group ring offset on) then appends that keep
# wrapping; a prompt inside the window whose appends wrap during decode
_STREAMS = {"long-prompt": (100, 40), "wrap-in-decode": (40, 60)}


def _ring_pair(method, stream, seed=0):
    """(JAX cache, port cache, per-step decode outputs of both) after the
    same prefill + append stream on a ring of WIN slots."""
    prompt, steps = _STREAMS[stream]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, H, prompt, D)).astype(np.float32)
    v = rng.standard_normal((B, H, prompt, D)).astype(np.float32)
    ks = rng.standard_normal((steps, B, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((steps, B, H, 1, D)).astype(np.float32)
    qs = rng.standard_normal((steps, B, 4 * H, D)).astype(np.float32)
    jc = jkv.init_cache(JQuantConfig(method=method, group_size=G), B, H, D,
                        WIN, dtype=jnp.float32, layout=JRing(WIN))
    tc = tkv.init_cache(QuantConfig(method=method, group_size=G), B, H, D,
                        WIN, dtype=torch.float32, device="cpu",
                        layout=RingLayout(WIN))
    jc = _j_prefill(jc, jnp.asarray(k), jnp.asarray(v))
    tkv.prefill(tc, t(k), t(v))
    outs = []
    for i in range(steps):
        if i in (0, steps // 2):
            _check_buffers(method, jc, tc)
        jc = _j_append(jc, jnp.asarray(ks[i]), jnp.asarray(vs[i]))
        tkv.append(tc, t(ks[i]), t(vs[i]))
        outs.append((np.asarray(_j_decode(jc, jnp.asarray(qs[i]),
                                          window=WIN)),
                     tkv.decode_attention(tc, t(qs[i]), window=WIN).numpy()))
    return jc, tc, outs


def _check_buffers(method, jc, tc):
    assert int(jc.length) == int(tc.length) == tc.host_length
    np.testing.assert_array_equal(tc.value_fp.numpy(),
                                  np.asarray(jc.value_fp))
    np.testing.assert_array_equal(tc.key_codes.numpy(),
                                  np.asarray(jc.key_codes))
    if method == "none":
        return
    np.testing.assert_array_equal(
        tc.key_residual.float().numpy(),
        np.asarray(jc.key_residual.astype(jnp.float32)))
    for name, buf in tc.key_scales.items():
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(jc.key_scales[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stream", sorted(_STREAMS))
@pytest.mark.parametrize("method", ["polar", "none"])
def test_ring_cache_stream_matches_jax(method, stream):
    jc, tc, outs = _ring_pair(method, stream)
    _check_buffers(method, jc, tc)
    assert tc.host_length == sum(_STREAMS[stream]) > WIN
    for want, got in outs:
        np.testing.assert_allclose(got, want, **TOL)


def test_ring_cache_refuses_the_fused_route():
    tc = tkv.init_cache(QuantConfig(group_size=G), B, H, D, WIN,
                        dtype=torch.float32, device="cpu",
                        layout=RingLayout(WIN))
    with pytest.raises(ValueError, match="linear layout"):
        tkv.fused_decode_attention(tc, torch.zeros((B, 4 * H, D)))


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rglru_pair():
    jcfg = j_reduce(j_get_config(NAME))
    cfg = reduce_for_smoke(get_config(NAME))
    jp = jrg.init_rglru_layer(jax.random.PRNGKey(3), jcfg)
    tp = {k: t(v) for k, v in jax.tree.map(np.asarray, jp).items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, tp, x


def test_rglru_mix_and_step_match_jax(rglru_pair):
    jcfg, jp, cfg, tp, x = rglru_pair
    jout, (jconv, jh) = jax.jit(
        lambda p, x: jrg.rglru_mix(p, x, jcfg, want_state=True))(
            jp, jnp.asarray(x))
    out, (conv, h) = RG.rglru_mix(tp, t(x), cfg, want_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    # a carried state, and one decode step from it
    x2 = np.random.default_rng(2).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jo2 = jrg.rglru_mix(jp, jnp.asarray(x2), jcfg, initial=(jconv, jh))
    o2 = RG.rglru_mix(tp, t(x2), cfg, initial=(conv, h))
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), rtol=1e-5,
                               atol=1e-5)
    jy, (jc2, jh2) = jrg.rglru_step(jp, jnp.asarray(x2[:, 0]), jcfg,
                                    (jconv, jh))
    y, (c2, h2) = RG.rglru_step(tp, t(x2[:, 0]), cfg, (conv, h))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=1e-5,
                               atol=1e-5)
    # a prompt shorter than the conv window pads its state in front
    _, (jc3, _) = jrg.rglru_mix(jp, jnp.asarray(x[:, :2]), jcfg,
                                want_state=True)
    _, (c3, _) = RG.rglru_mix(tp, t(x[:, :2]), cfg, want_state=True)
    np.testing.assert_array_equal(c3.numpy(), np.asarray(jc3))


@pytest.mark.parametrize("t0,k", [(20, 17), (1, 8), (36, 1)])
def test_rglru_prefill_then_steps_equals_longer_prefill(rglru_pair, t0, k):
    _, _, cfg, tp, x = rglru_pair
    full = RG.rglru_mix(tp, t(x[:, :t0 + k]), cfg)
    out, state = RG.rglru_mix(tp, t(x[:, :t0]), cfg, want_state=True)
    torch.testing.assert_close(out, full[:, :t0], rtol=1e-5, atol=1e-5)
    for i in range(k):
        y, state = RG.rglru_step(tp, t(x[:, t0 + i]), cfg, state)
        torch.testing.assert_close(y, full[:, t0 + i], rtol=1e-5, atol=1e-5)
    cont = RG.rglru_mix(tp, t(x[:, t0:t0 + k]), cfg,
                        initial=RG.rglru_mix(tp, t(x[:, :t0]), cfg,
                                             want_state=True)[1])
    torch.testing.assert_close(cont, full[:, t0:], rtol=1e-5, atol=1e-5)


def test_linear_scan_matches_a_sequential_loop():
    rng = np.random.default_rng(4)
    a = t(rng.uniform(0.5, 1.0, (2, 45, 7)).astype(np.float32))
    b = t(rng.standard_normal((2, 45, 7)).astype(np.float32))
    h, want = torch.zeros((2, 7)), []
    for i in range(45):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(RG.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model and the static engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduce(j_get_config(NAME))
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config(NAME))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _prompts(vocab, b=2, tp=90, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


def test_smoke_config_has_both_layer_kinds_and_a_tail(weights):
    _, _, cfg, tp = weights
    assert HY.layer_types(cfg) == ["rec", "rec", "attn", "rec"]
    assert cfg.window == WIN and cfg.num_kv_heads == 1
    assert [sorted(lp["mix"]) for lp in tp["layers"]][2] == \
        ["wk", "wo", "wq", "wv"]


def _jax_layers(jstate, cfg):
    """JAX's hybrid state (period- and tail-stacked) as one numpy tree per
    layer, in layer order."""
    n_periods, pat, tail = HY._period_split(cfg)
    tree = jax.tree.map(np.asarray, jstate)
    out = [jax.tree.map(lambda a, p=p: a[p],
                        tree["periods"][f"sub{j}_{kind}"])
           for p in range(n_periods) for j, kind in enumerate(pat)]
    return out + [jax.tree.map(lambda a, i=i: a[i], tree["tail"])
                  for i in range(len(tail))]


def _cache_buffers(c):
    return {"key_codes": c.key_codes, "key_residual": c.key_residual,
            "value_fp": c.value_fp, "length": c.length, **c.key_scales}


def _check_state(tstate, jstate, cfg):
    """Ring caches: codes equal; stats and values within 1e-4 (the
    attention tolerance: the keys differ by the float32 rounding of the
    layers below, as in ``tests/test_torch_configs.py``); the bf16 residual
    within one bf16 step (2^-7 relative). Recurrent states: conv and h
    within 1e-5."""
    for tc, jc in zip(tstate, _jax_layers(jstate, cfg)):
        if isinstance(tc, tuple):
            for a, b in zip(tc, jc):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-5)
            continue
        assert int(tc.length) == int(jc.length) == tc.host_length
        np.testing.assert_array_equal(tc.key_codes.numpy(), jc.key_codes)
        for n, buf in tc.key_scales.items():
            np.testing.assert_allclose(buf.numpy(), jc.key_scales[n], **TOL)
        np.testing.assert_allclose(tc.value_fp.numpy(), jc.value_fp, **TOL)
        np.testing.assert_allclose(tc.key_residual.float().numpy(),
                                   jc.key_residual.astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def _load_state(tstate, jstate, cfg):
    """Copy JAX's state into the port's, in place (a recurrent layer's
    entry replaced)."""
    for i, jc in enumerate(_jax_layers(jstate, cfg)):
        if isinstance(tstate[i], tuple):
            tstate[i] = tuple(t(x) for x in jc)
            continue
        bufs = _cache_buffers(jc)
        for n, dst in _cache_buffers(tstate[i]).items():
            dst.copy_(t(bufs[n]).to(dst.dtype))


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_matches_jax(weights, backend):
    """A 90-token prompt wraps the 64-slot ring at prefill; 16 decode
    steps keep wrapping it (the flush at position 95 writes group slot 0
    over the oldest group). The ring layer stays on the score route on
    both backends."""
    jcfg, jp, cfg, tp = weights
    jm = j_get_model(dataclasses.replace(jcfg, decode_backend=backend))
    tm = get_model(dataclasses.replace(cfg, decode_backend=backend))
    toks = _prompts(cfg.vocab_size)
    jeng = JServe(jm, jp, max_len=256)
    jout = jeng.generate({"tokens": jnp.asarray(toks)},
                         JGen(max_new_tokens=17))
    with mock.patch.object(pak, "polar_decode_attention_grouped",
                           side_effect=AssertionError("fused route")):
        tout = ServeEngine(tm, tp, max_len=256, device="cpu").generate(
            {"tokens": toks}, GenerationConfig(max_new_tokens=17))
        np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
        assert tout["cache_bytes"] == jout["cache_bytes"]
        assert tout["cache_bytes_per_layer"] is None
        assert jout["cache_bytes_per_layer"] is None

        jst = jm.init_decode_state(2, 256)
        tst = tm.init_decode_state(2, 256, "cpu")
        assert tst[2].max_len == WIN and isinstance(tst[2].layout,
                                                    RingLayout)
        jl, jst = jeng._prefill(jp, {"tokens": jnp.asarray(toks)}, jst)
        tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                             tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_state(tst, jst, cfg)
        for i in range(16):
            _load_state(tst, jst, cfg)
            tok = jout["tokens"][:, i]
            jl, jst = jeng._decode(jp, jst, jnp.asarray(tok))
            tl, tst = tm.decode(tp, tst, torch.tensor(tok).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tst[2].host_length == 90 + 16


def test_model_prefill_then_steps_equals_longer_prefill(weights):
    """On the fp cache (no key quantization between the two paths) a
    prefill of T then k decode steps gives the logits of a prefill of
    T + k: the ring, the local mask and the recurrent state carry over.
    T 60 + 10 crosses the 64-slot window."""
    _, _, cfg, tp = weights
    tm = get_model(dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, method="none")))
    toks = torch.from_numpy(_prompts(cfg.vocab_size, tp=70, seed=5)).long()
    st = tm.init_decode_state(2, 256, "cpu")
    _, st = tm.prefill(tp, {"tokens": toks[:, :60]}, st)
    for i in range(60, 70):
        want, _ = tm.prefill(tp, {"tokens": toks[:, :i + 1]},
                             tm.init_decode_state(2, 256, "cpu"))
        got, st = tm.decode(tp, st, toks[:, i])
        torch.testing.assert_close(got, want, **TOL)


def test_static_only_families_refuse_the_paged_engine(weights):
    _, jp, cfg, tp = weights
    jcfg = j_reduce(j_get_config(NAME))
    with pytest.raises(ValueError, match="no paged decode path") as te:
        EngineCore(get_model(cfg), tp, device="cpu")
    with pytest.raises(ValueError, match="no paged decode path") as je:
        JCore(j_get_model(jcfg), jp)
    assert str(te.value) == str(je.value)
    vcfg = reduce_for_smoke(get_config("paligemma-3b"))
    with pytest.raises(ValueError, match="no paged decode path"):
        EngineCore(get_model(vcfg), {}, device="cpu")


def test_hybrid_refuses_per_layer_policies():
    cfg = reduce_for_smoke(get_config(NAME))
    int8 = QuantConfig(method="int", key_bits=8, group_size=32)
    with pytest.raises(ValueError, match="per-layer") as te:
        get_model(dataclasses.replace(
            cfg, cache_policy=CachePolicy.first_k(1, int8, cfg.quant)))
    jcfg = j_reduce(j_get_config(NAME))
    jint8 = JQuantConfig(method="int", key_bits=8, group_size=32)
    with pytest.raises(ValueError, match="per-layer") as je:
        j_get_model(dataclasses.replace(
            jcfg, cache_policy=JPolicy.first_k(1, jint8, jcfg.quant)))
    assert str(te.value) == str(je.value)
    # a uniform policy passes, as in JAX
    get_model(dataclasses.replace(cfg, cache_policy=CachePolicy.uniform(
        cfg.quant)))
