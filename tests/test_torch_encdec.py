"""Port parity: the encoder-decoder family (seamless-m4t-medium,
``repro_torch/models/encdec.py`` and the forward entries of
``attn_block.py``) against the JAX package.

* ``attention_train`` in ``full`` mode (the encoder's RoPE'd
  self-attention) and as cross-attention (Tq != Tk, keys from the
  memory, no RoPE) within 1e-4; ``encode`` within 1e-4.
* The cross cache filled from the un-rotated memory keys: codes equal,
  stats within 1e-6, the bf16 residual within one bf16 step — with the
  smoke's 16 frames (the residual only) and with 80 frames at g 32 (two
  flushed groups, so cross decode reaches the plain version of the
  score-only LUT kernel). Cross decode takes the score route on both
  decode backends and agrees with JAX's within 1e-4.
* ``ServeEngine`` on both static routes: greedy tokens identical to
  JAX's over 16 steps (the self cache flushes a group among them),
  prefill logits within 1e-4 and the state held to JAX's, then every
  decode step runs from JAX's state on both sides and its logits agree
  within 1e-4.
* The linear self cache's capacity: the port refuses a prompt + new
  tokens past ``max_len``; JAX's engine does not check, and decodes past
  the capacity with finite logits.
* JAX's ``param_count`` is short of the params drawn by
  ``frontend_proj`` and ``enc_norm`` (4,224 at smoke size, 164,864 at
  full size); the port returns JAX's value.
* The refusals: ``frames`` of another length than ``frontend_tokens``,
  ``EngineCore`` and per-layer cache policies."""
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
from repro.models import attn_block as jab  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import EngineCore as JCore  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import CachePolicy, QuantConfig  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.kernels import polar_qk as qkk  # noqa: E402
from repro_torch.models import attn_block as AB  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import EngineCore  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    """numpy (or JAX) -> torch; bf16 arrays through float32 (exact)."""
    x = np.array(x)
    return torch.from_numpy(x.astype(np.float32) if x.dtype.name ==
                            "bfloat16" else x)


def _cfgs(**kw):
    return (dataclasses.replace(j_reduce(j_get_config(NAME)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(NAME)), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _frames(cfg, b=2, seed=0):
    return _rand((b, cfg.frontend_tokens, cfg.frontend_dim), seed)


def _prompts(vocab, b=2, tp=20, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["dec_layers"]),
            tp["dec_layers"][i])


def test_params_carry_over(weights):
    _, _, cfg, tp = weights
    assert len(tp["enc_layers"]) == cfg.encoder_layers == 2
    assert len(tp["dec_layers"]) == cfg.num_layers == 2
    assert sorted(tp["dec_layers"][0]) == ["attn", "ffn", "ln1", "ln2",
                                           "ln_x", "xattn"]
    assert sorted(tp["enc_layers"][0]) == ["attn", "ffn", "ln1", "ln2"]
    assert tp["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert tp["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    assert tp["enc_norm"].dtype == torch.float32
    bf = reduce_for_smoke(get_config(NAME), dtype="bfloat16")
    p = get_model(bf).init(generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert p["frontend_proj"].dtype == p["lm_head"].dtype == torch.bfloat16
    assert p["dec_layers"][0]["xattn"]["wq"].dtype == torch.bfloat16
    assert p["dec_layers"][0]["ln_x"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["full", "causal", "cross"])
def test_attention_train_matches_jax(weights, mode):
    """``full``: the encoder's bidirectional RoPE'd self-attention over 24
    tokens; ``cross``: 9 decoder queries over 16 memory frames."""
    jcfg, jp, cfg, tp = weights
    jl, tl = _layer(jp, tp)
    key = "xattn" if mode == "cross" else "attn"
    x = _rand((2, 9 if mode == "cross" else 24, cfg.d_model), 1)
    mem = _rand((2, 16, cfg.d_model), 2) if mode == "cross" else None
    mask = "full" if mode == "cross" else mode
    want = jax.jit(lambda p, x, m: jab.attention_train(
        p, x, jcfg, mask_mode=mask, memory=m))(
            jl[key], jnp.asarray(x),
            None if mem is None else jnp.asarray(mem))
    got = AB.attention_train(tl[key], t(x), cfg, mask_mode=mask,
                             memory=None if mem is None else t(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax(weights):
    jcfg, jp, cfg, tp = weights
    fr = _frames(cfg)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg, remat="none"))(
        jp, jnp.asarray(fr))
    got = ED.encode(tp, t(fr), cfg)
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_buffers(c):
    return {"key_codes": c.key_codes, "key_residual": c.key_residual,
            "value_fp": c.value_fp, "length": c.length, **c.key_scales}


def _check_cache(tc, jc, stats_tol=1e-6):
    """Codes and length equal; stats within ``stats_tol``; values within
    1e-4; the bf16 residual within one bf16 step (a key that differs by
    float32 ulps may round to the other bf16 neighbour)."""
    assert int(tc.length) == int(jc.length) == tc.host_length
    np.testing.assert_array_equal(tc.key_codes.numpy(),
                                  np.asarray(jc.key_codes))
    for n, buf in tc.key_scales.items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jc.key_scales[n]),
                                   rtol=stats_tol, atol=stats_tol)
    np.testing.assert_allclose(tc.value_fp.numpy(), np.asarray(jc.value_fp),
                               **TOL)
    np.testing.assert_allclose(t(jc.key_residual).numpy(),
                               tc.key_residual.float().numpy(),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("frames", [16, 80])
def test_cross_cache_and_cross_decode_match_jax(weights, frames):
    """16 frames fill the residual of a 32-slot cross cache; 80 frames
    (``frontend_tokens=80``) flush two groups of 32 and leave 16 in the
    residual. Cross decode: no RoPE, no append, the score route on both
    backends (never the fused kernel)."""
    jcfg, jp, cfg, tp = weights
    jl, tl = _layer(jp, tp)
    mem = _rand((2, frames, cfg.d_model), 3)
    x = _rand((2, 1, cfg.d_model), 4)
    # jitted: the first eager call of each JAX op compiles it, seconds in all
    jc = jax.jit(lambda p, m: jab.cross_attention_cache(
        p, m, jcfg, jab.make_cache(jcfg, 2, frames)))(jl["xattn"],
                                                      jnp.asarray(mem))
    for backend in ("jnp", "paged_fused"):
        bcfg = dataclasses.replace(cfg, decode_backend=backend)
        tc = AB.cross_attention_cache(tl["xattn"], t(mem), bcfg,
                                      AB.make_cache(bcfg, 2, frames,
                                                    device="cpu"))
        assert tc.max_len == -(-frames // 32) * 32
        _check_cache(tc, jc)
        want, jc2 = jax.jit(lambda p, x, c, b=backend: jab.attention_decode(
            p, x, dataclasses.replace(jcfg, decode_backend=b), c,
            cross=True))(jl["xattn"], jnp.asarray(x), jc)
        assert int(jc2.length) == frames
        scores = qkk.polar_qk_scores
        with mock.patch.object(pak, "polar_decode_attention_grouped",
                               side_effect=AssertionError("fused route")), \
                mock.patch.object(qkk, "polar_qk_scores",
                                  side_effect=scores) as qk:
            got, tc2 = AB.attention_decode(tl["xattn"], t(x), bcfg, tc,
                                           cross=True)
        assert qk.call_count == 1 and tc2.host_length == frames
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_layers(jstate, n):
    tree = jax.tree.map(np.asarray, jstate)
    return [jax.tree.map(lambda a, i=i: a[i], tree) for i in range(n)]


def _check_state(tstate, jstate, n):
    for part in ("self", "cross"):
        for tc, jc in zip(tstate[part], _jax_layers(jstate[part], n)):
            _check_cache(tc, jc, stats_tol=1e-4)


def _load_state(tstate, jstate, n):
    """Copy JAX's state into the port's caches, in place."""
    for part in ("self", "cross"):
        for tc, jc in zip(tstate[part], _jax_layers(jstate[part], n)):
            bufs = _cache_buffers(jc)
            for name, dst in _cache_buffers(tc).items():
                dst.copy_(t(bufs[name]).to(dst.dtype))
            tc.host_length = int(tc.length)


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_matches_jax(weights, backend):
    """A 20-token prompt over 16 frames; 16 decode steps, the self cache
    flushing its first group of 32 at position 31. ``"jnp"`` decodes the
    self cache on the score route, ``"paged_fused"`` on the fused kernel;
    the cross cache takes the score route on both."""
    jcfg, jp, cfg, tp = weights
    jm = j_get_model(dataclasses.replace(jcfg, decode_backend=backend))
    tm = get_model(dataclasses.replace(cfg, decode_backend=backend))
    toks, fr = _prompts(cfg.vocab_size), _frames(cfg)
    jeng = JServe(jm, jp, max_len=64)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    jout = jeng.generate(jb, JGen(max_new_tokens=17))
    fused = pak.polar_decode_attention_grouped
    with mock.patch.object(pak, "polar_decode_attention_grouped",
                           side_effect=fused) as fk:
        tout = ServeEngine(tm, tp, max_len=64, device="cpu").generate(
            {"tokens": toks, "frames": fr},
            GenerationConfig(max_new_tokens=17))
    assert fk.call_count == (16 * cfg.num_layers
                             if backend == "paged_fused" else 0)
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes"] == jout["cache_bytes"]
    assert tout["cache_bytes_per_layer"] is None

    n = cfg.num_layers
    jst = jm.init_decode_state(2, 64)
    tst = tm.init_decode_state(2, 64, "cpu")
    jl, jst = jeng._prefill(jp, jb, jst)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                              "frames": t(fr)}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_state(tst, jst, n)
    for i in range(16):
        _load_state(tst, jst, n)
        tok = jout["tokens"][:, i]
        jl, jst = jeng._decode(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.tensor(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tst["self"][0].host_length == 20 + 16
    assert tst["cross"][0].host_length == cfg.frontend_tokens


def test_capacity_refused_where_jax_overflows(weights):
    """max_len 32, a 30-token prompt, 7 new tokens (6 appends): the port
    refuses; JAX's engine runs, and its self cache ends at length 36 past
    its capacity of 32 with finite logits."""
    jcfg, jp, cfg, tp = weights
    toks, fr = _prompts(cfg.vocab_size, tp=30), _frames(cfg)
    with pytest.raises(ValueError, match="exceeds cache capacity 32"):
        ServeEngine(get_model(cfg), tp, max_len=32, device="cpu").generate(
            {"tokens": toks, "frames": fr}, GenerationConfig(
                max_new_tokens=7))
    jm = j_get_model(jcfg)
    jeng = JServe(jm, jp, max_len=32)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    jout = jeng.generate(jb, JGen(max_new_tokens=7))
    assert np.asarray(jout["tokens"]).shape == (2, 7)
    lg, st = jeng._prefill(jp, jb, jm.init_decode_state(2, 32))
    for i in range(6):
        lg, st = jeng._decode(jp, st, jnp.asarray(jout["tokens"][:, i]))
    assert st["self"].max_len == 32
    assert np.asarray(st["self"].length).tolist() == [36] * cfg.num_layers
    assert np.isfinite(np.asarray(lg)).all()


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_count_is_jax_value_with_its_gap(size):
    """JAX's encdec ``param_count`` leaves out ``frontend_proj``
    (frontend_dim x D) and ``enc_norm`` (D); the port keeps JAX's value.
    Counted from shapes, nothing allocated at full size."""
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    if size == "smoke":
        jcfg, cfg = j_reduce(jcfg), reduce_for_smoke(cfg)
    shapes = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))
    drawn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    gap = cfg.frontend_dim * cfg.d_model + cfg.d_model
    assert cfg.param_count() == jcfg.param_count() == drawn - gap
    assert gap == {"smoke": 4_224, "full": 164_864}[size]


def test_refusals(weights):
    """Frames of another length than ``frontend_tokens``; ``EngineCore``
    (no paged path; JAX's message); per-layer cache policies (JAX's
    message)."""
    jcfg, jp, cfg, tp = weights
    tm = get_model(cfg)
    with pytest.raises(ValueError, match="frontend_tokens = 16"):
        tm.prefill(tp, {"tokens": torch.zeros((2, 4), dtype=torch.long),
                        "frames": t(_rand((2, 15, cfg.frontend_dim), 0))},
                   tm.init_decode_state(2, 32, "cpu"))
    with pytest.raises(ValueError, match="no paged decode path") as te:
        EngineCore(tm, tp, device="cpu")
    with pytest.raises(ValueError, match="no paged decode path") as je:
        JCore(j_get_model(jcfg), jp)
    assert str(te.value) == str(je.value)
    int8 = QuantConfig(method="int", key_bits=8, group_size=32)
    with pytest.raises(ValueError, match="per-layer") as te:
        get_model(dataclasses.replace(
            cfg, cache_policy=CachePolicy.first_k(1, int8, cfg.quant)))
    jint8 = JQuantConfig(method="int", key_bits=8, group_size=32)
    with pytest.raises(ValueError, match="per-layer") as je:
        j_get_model(dataclasses.replace(
            jcfg, cache_policy=JPolicy.first_k(1, jint8, jcfg.quant)))
    assert str(te.value) == str(je.value)
