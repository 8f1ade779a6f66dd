"""Port parity: the Mamba-2 SSM family (mamba2-2.7b,
``repro_torch/models/mamba2.py`` and ``ssm_lm.py``) against the JAX
package.

* ``_causal_conv``, ``_conv_step``, ``mamba_mix`` (with and without
  ``want_state``, and from a carried state) and ``mamba_step`` within
  1e-5 (their states too: the conv window holds ``in_proj`` outputs,
  which differ from JAX's by float32 ulps); ``ssd_chunked`` at T a
  multiple of the chunk and ragged, with and without an initial state,
  within 1e-5.
* A prefill of T then k steps equals a prefill of T + k (the SSD
  duality), for the mixer and the whole model.
* ``ServeEngine`` on the smoke mamba2: greedy tokens identical to JAX's
  over 16 steps, prefill logits and state within 1e-4, then every decode
  step runs from JAX's state on both sides and its logits agree within
  1e-4.
* A prompt shorter than the conv window (2 tokens): JAX's next decode
  fails (its conv state keeps fewer than W - 1 rows); the port's state is
  zero-padded and equals stepping the same tokens from the zero state.
* JAX's ``param_count`` is short of the params drawn by ``conv_b`` and
  one per-head vector per layer (608 at smoke size, 349,184 at full
  size); the port returns JAX's value.
* In bf16, where the port's prefill conv rounds once and JAX's three
  times: prefill logits and state within rel. L2 2^-5 of JAX's, a decode
  step from JAX's state within 2^-10.
* The refusals: ``EngineCore`` and per-layer cache policies."""
import dataclasses

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
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.serve import EngineCore as JCore  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import CachePolicy, QuantConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.serve import EngineCore  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "mamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
MIX = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduce(j_get_config(NAME))
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config(NAME))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def layer(weights):
    """One mixer's params on both sides and a (2, 45, D) input."""
    jcfg, jp, cfg, tp = weights
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    x = np.random.default_rng(1).standard_normal(
        (2, 45, cfg.d_model)).astype(np.float32)
    return jcfg, jl, cfg, tp["layers"][0], x


def test_smoke_dims_and_param_dtypes(weights):
    _, _, cfg, tp = weights
    dm = M2.dims(cfg)
    assert dm == (256, 16, 16, 1, 16, 288, 4)
    lp = tp["layers"][0]
    assert lp["in_proj"].shape == (cfg.d_model, 2 * 256 + 32 + 16)
    assert lp["conv_w"].shape == (4, 288)
    assert all(lp[n].dtype == torch.float32 for n in lp)
    bf = reduce_for_smoke(get_config(NAME), dtype="bfloat16")
    p = get_model(bf).init(generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert {n for n, a in p["layers"][0].items()
            if a.dtype == torch.bfloat16} == {"in_proj", "out_proj"}
    assert "lm_head" not in p                  # tied embeddings


def test_conv_and_mixer_match_jax(layer):
    jcfg, jl, cfg, tl, x = layer
    dm = M2.dims(cfg)
    u = np.random.default_rng(2).standard_normal(
        (2, 45, dm.conv_dim)).astype(np.float32)
    np.testing.assert_allclose(
        M2._causal_conv(t(u), tl["conv_w"], tl["conv_b"]).numpy(),
        np.asarray(jm2._causal_conv(jnp.asarray(u), jl["conv_w"],
                                    jl["conv_b"])), **MIX)
    st = u[:, :3]
    jy, jst = jm2._conv_step(jnp.asarray(u[:, 3]), jnp.asarray(st),
                             jl["conv_w"], jl["conv_b"])
    y, st2 = M2._conv_step(t(u[:, 3]), t(st), tl["conv_w"], tl["conv_b"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MIX)
    np.testing.assert_array_equal(st2.numpy(), np.asarray(jst))

    mix = jax.jit(lambda p, x: jm2.mamba_mix(p, x, jcfg))
    np.testing.assert_allclose(M2.mamba_mix(tl, t(x), cfg).numpy(),
                               np.asarray(mix(jl, jnp.asarray(x))), **MIX)
    # jitted: the first eager call of each JAX op compiles it, seconds in all
    mix = jax.jit(lambda p, x, init: jm2.mamba_mix(
        p, x, jcfg, initial=init, want_state=True))
    jo, (jc, js) = mix(jl, jnp.asarray(x), None)
    o, (c, s) = M2.mamba_mix(tl, t(x), cfg, want_state=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **MIX)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **MIX)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **MIX)
    # from a carried state: a chunk of tokens, then one step
    x2 = np.random.default_rng(3).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    jo2, (jc2, js2) = mix(jl, jnp.asarray(x2), (jc, js))
    o2, (c2, s2) = M2.mamba_mix(tl, t(x2), cfg, initial=(c, s),
                                want_state=True)
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), **MIX)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), **MIX)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **MIX)
    jy, (jc3, js3) = jax.jit(lambda p, x, st: jm2.mamba_step(
        p, x, jcfg, st))(jl, jnp.asarray(x2[:, 0]), (jc2, js2))
    y, (c3, s3) = M2.mamba_step(tl, t(x2[:, 0]), cfg, (c2, s2))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MIX)
    np.testing.assert_allclose(c3.numpy(), np.asarray(jc3), **MIX)
    np.testing.assert_allclose(s3.numpy(), np.asarray(js3), **MIX)


def test_prefill_conv_rounds_once_as_the_step():
    """In bf16 the prefill conv computes in fp32 and rounds once, as the
    decode step's conv: stepping ``_conv_step`` through the tokens gives
    its output within one bf16 rounding (the two sum the 4 taps in other
    orders), and the old rounding points (conv, bias add and SiLU each in
    bf16, as JAX's) do not."""
    rng = np.random.default_rng(5)
    c = 64
    u = t(rng.standard_normal((2, 12, c)).astype(np.float32)).bfloat16()
    w = t(0.2 * rng.standard_normal((4, c)).astype(np.float32))
    b = t(0.1 * rng.standard_normal(c).astype(np.float32))
    got = M2._causal_conv(u, w, b)
    assert got.dtype == torch.bfloat16
    state = torch.zeros((2, 3, c), dtype=torch.bfloat16)
    steps = []
    for i in range(12):
        y, state = M2._conv_step(u[:, i], state, w, b)
        steps.append(y)
    want = torch.stack(steps, 1).float()
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-6)
    x = torch.nn.functional.pad(u.transpose(1, 2), (3, 0))
    old = torch.nn.functional.silu(torch.nn.functional.conv1d(
        x, w.t()[:, None, :].bfloat16(), groups=c).transpose(1, 2)
        + b.bfloat16())
    assert (old.float() - want).abs().max() > (got.float() - want).abs().max()


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("steps", [64, 45])
def test_ssd_chunked_matches_jax(steps, initial):
    """T = 2 chunks of 32, and T = 45 (the last chunk zero-padded)."""
    rng = np.random.default_rng(steps + initial)
    b, g, r, p, n = 2, 1, 4, 8, 16
    xdt = rng.standard_normal((b, steps, g, r, p)).astype(np.float32)
    adt = -rng.uniform(0.01, 0.5, (b, steps, g, r)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, steps, g, n)).astype(np.float32)
              for _ in range(2))
    s0 = (rng.standard_normal((b, g, r, p, n)).astype(np.float32)
          if initial else None)
    jy, js = jm2.ssd_chunked(jnp.asarray(xdt), jnp.asarray(adt),
                             jnp.asarray(bb), jnp.asarray(cc), 32,
                             None if s0 is None else jnp.asarray(s0))
    y, s = M2.ssd_chunked(t(xdt), t(adt), t(bb), t(cc), 32,
                          None if s0 is None else t(s0))
    assert y.shape == (b, steps, g, r, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MIX)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **MIX)


@pytest.mark.parametrize("t0,k", [(36, 9), (1, 6), (32, 1)])
def test_mixer_prefill_then_steps_equals_longer_prefill(layer, t0, k):
    _, _, cfg, tl, x = layer
    full = M2.mamba_mix(tl, t(x[:, :t0 + k]), cfg)
    out, state = M2.mamba_mix(tl, t(x[:, :t0]), cfg, want_state=True)
    torch.testing.assert_close(out, full[:, :t0], **MIX)
    for i in range(k):
        y, state = M2.mamba_step(tl, t(x[:, t0 + i]), cfg, state)
        torch.testing.assert_close(y, full[:, t0 + i], **MIX)


def _prompts(vocab, b=2, tp=45, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


def test_model_prefill_then_steps_equals_longer_prefill(weights):
    _, _, cfg, tp = weights
    tm = get_model(cfg)
    toks = torch.from_numpy(_prompts(cfg.vocab_size, tp=50, seed=5)).long()
    st = tm.init_decode_state(2, 64, "cpu")
    _, st = tm.prefill(tp, {"tokens": toks[:, :40]}, st)
    for i in range(40, 50):
        want, _ = tm.prefill(tp, {"tokens": toks[:, :i + 1]},
                             tm.init_decode_state(2, 64, "cpu"))
        got, st = tm.decode(tp, st, toks[:, i])
        torch.testing.assert_close(got, want, **TOL)


def _check_state(tstate, jstate):
    conv, ssd = (np.asarray(a) for a in jstate)
    for i, (c, s) in enumerate(tstate):
        np.testing.assert_allclose(c.numpy(), conv[i], **TOL)
        np.testing.assert_allclose(s.numpy(), ssd[i], **TOL)


def _load_state(tstate, jstate):
    conv, ssd = (np.asarray(a) for a in jstate)
    for i in range(len(tstate)):
        tstate[i] = (t(conv[i]), t(ssd[i]))


def test_serve_engine_matches_jax(weights):
    """A 45-token prompt (a ragged second chunk), 16 decode steps."""
    jcfg, jp, cfg, tp = weights
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _prompts(cfg.vocab_size)
    jeng = JServe(jm, jp, max_len=64)
    jout = jeng.generate({"tokens": jnp.asarray(toks)},
                         JGen(max_new_tokens=17))
    tout = ServeEngine(tm, tp, max_len=64, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=17))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes"] == jout["cache_bytes"] == \
        cfg.num_layers * 2 * (3 * 288 + 16 * 16 * 16) * 4
    assert tout["cache_bytes_per_layer"] is None
    jst = jm.init_decode_state(2, 64)
    tst = tm.init_decode_state(2, 64, "cpu")
    jl, jst = jeng._prefill(jp, {"tokens": jnp.asarray(toks)}, jst)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_state(tst, jst)
    for i in range(16):
        _load_state(tst, jst)
        tok = jout["tokens"][:, i]
        jl, jst = jeng._decode(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.tensor(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_state(tst, jst)


def test_short_prompt_state_is_zero_padded(weights):
    """A 2-token prompt leaves JAX a 1-row conv state, and its next decode
    fails; the port pads the state with zeros, the causal conv's own
    padding, so prefill(2) + a step equals three steps from the zero
    state."""
    jcfg, jp, cfg, tp = weights
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _prompts(cfg.vocab_size, tp=3, seed=7)
    _, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :2])},
                        jm.init_decode_state(2, 64))
    assert jst[0].shape[2] == 1 < M2.dims(cfg).conv_w - 1
    with pytest.raises(ValueError, match="label 'w'"):
        jm.decode(jp, jst, jnp.asarray(toks[:, 2]))
    tt = torch.from_numpy(toks).long()
    _, st = tm.prefill(tp, {"tokens": tt[:, :2]},
                       tm.init_decode_state(2, 64, "cpu"))
    got, st = tm.decode(tp, st, tt[:, 2])
    ref = tm.init_decode_state(2, 64, "cpu")
    for i in range(3):
        want, ref = tm.decode(tp, ref, tt[:, i])
    torch.testing.assert_close(got, want, **MIX)
    for (c, s), (rc, rs) in zip(st, ref):
        torch.testing.assert_close(c, rc, **MIX)
        torch.testing.assert_close(s, rs, **MIX)


def _rel(a, b):
    """Rel. L2 of ``a`` from ``b`` per row, in fp32."""
    a, b = (np.asarray(x, np.float32) for x in (a, b))
    return np.linalg.norm((a - b).reshape(len(b), -1), axis=-1) \
        / np.linalg.norm(b.reshape(len(b), -1), axis=-1)


def test_bf16_prefill_and_step_match_jax():
    """In bf16 the port's prefill conv rounds once where JAX's rounds the
    conv, the bias add and the SiLU apart (ROADMAP §3). The prefill's
    logits and state stay within rel. L2 2^-5 (four bf16 steps) of
    JAX's, over a ragged second chunk. A decode step from JAX's state,
    where both round at the same points and differ only in the order of
    fp32 sums, within 2^-10 (a quarter of one bf16 rounding; it reads 0
    on the CPU)."""
    jcfg = j_reduce(j_get_config(NAME), dtype="bfloat16")
    cfg = reduce_for_smoke(get_config(NAME), dtype="bfloat16")
    jm, tm = j_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = _prompts(cfg.vocab_size)
    jl, jst = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                  jm.init_decode_state(2, 64))
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                         tm.init_decode_state(2, 64, "cpu"))
    assert tl.dtype == torch.bfloat16
    assert _rel(tl.float(), jl).max() <= 2 ** -5
    conv, ssd = (np.asarray(a, np.float32) for a in jst)
    for i, (c, s) in enumerate(tst):
        assert _rel(c.float(), conv[i]).max() <= 2 ** -5
        assert _rel(s, ssd[i]).max() <= 2 ** -5
    for i in range(len(tst)):
        tst[i] = (t(conv[i]).bfloat16(), t(ssd[i]))
    tok = toks[:, -1]
    jl, _ = jax.jit(jm.decode)(jp, jst, jnp.asarray(tok))
    tl, _ = tm.decode(tp, tst, torch.from_numpy(tok).long())
    assert _rel(tl.float(), jl).max() <= 2 ** -10


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_count_is_jax_value_with_its_gap(size):
    """JAX's ssm ``param_count`` leaves out ``conv_b`` (conv_dim) and one
    of ``A_log`` / ``dt_bias`` / ``D`` (nheads) per layer; the port keeps
    JAX's value. Counted from shapes, nothing allocated at full size."""
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    if size == "smoke":
        jcfg, cfg = j_reduce(jcfg), reduce_for_smoke(cfg)
    shapes = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))
    drawn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    dm = M2.dims(cfg)
    gap = cfg.num_layers * (dm.conv_dim + dm.nheads)
    assert cfg.param_count() == jcfg.param_count() == drawn - gap
    assert gap == {"smoke": 608, "full": 349_184}[size]
    if size == "smoke":
        tp = get_model(cfg).init(generator=torch.Generator().manual_seed(0),
                                 device="cpu")
        assert sum(a.numel() for lp in tp["layers"] for a in lp.values()) \
            + tp["embed"].numel() + tp["final_norm"].numel() == drawn


def test_refusals(weights):
    """``EngineCore`` (no paged path; JAX's message) and per-layer cache
    policies (JAX's message), as JAX."""
    jcfg, jp, cfg, tp = weights
    with pytest.raises(ValueError, match="no paged decode path") as te:
        EngineCore(get_model(cfg), tp, device="cpu")
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
    with pytest.raises(ValueError, match="unknown family") as te:
        get_model(dataclasses.replace(cfg, family="rnn"))
    with pytest.raises(ValueError, match="unknown family") as je:
        j_get_model(dataclasses.replace(jcfg, family="rnn"))
    assert str(te.value) == str(je.value)
