"""Port parity: ``repro_torch``'s static ``ServeEngine`` (dense caches) and
the paged ``EngineCore`` on its gathered decode routes, against the JAX
engines on shared weights (the fp32 tinyllama smoke config, params through
``params_from_jax``).

``ServeEngine`` under ``decode_backend`` ``"jnp"`` (score-only LUT path)
and ``"paged_fused"`` (the fused dense kernel), for the ``"polar"`` and
``"none"`` codecs: identical greedy tokens, logits within 1e-4 after
prefill and over 16 teacher-forced decode steps (one group flush among
them), equal ``cache_bytes``, EOS masking, and temperature sampling held
to the JAX formula by feeding both the same Gumbel noise. ``EngineCore``
under ``"jnp"`` and ``"gathered"``: the same streams and events as JAX's
on a ``tests/test_continuous_batching.py`` workload (arrivals as a burst,
see ``tests/test_torch_serve.py``)."""
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
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.serve import core as tcore  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

MAX_LEN = 128
PROMPT = 50                   # smoke g = 32: decode positions 50.. flush at 63
STEPS = 16


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduce(j_get_config("tinyllama-1.1b"))
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _models(weights, backend, method):
    jcfg, jp, cfg, tp = weights

    def cfg_of(c):
        return dataclasses.replace(
            c, decode_backend=backend,
            quant=dataclasses.replace(c.quant, method=method))

    return j_get_model(cfg_of(jcfg)), jp, get_model(cfg_of(cfg)), tp


def _prompts(vocab, b=2, tp=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


@pytest.mark.parametrize("method", ["polar", "none"])
@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_matches_jax(weights, backend, method):
    jm, jp, tm, tp = _models(weights, backend, method)
    toks = _prompts(tm.cfg.vocab_size)
    jeng = JServe(jm, jp, max_len=MAX_LEN)
    jout = jeng.generate({"tokens": jnp.asarray(toks)},
                         JGen(max_new_tokens=STEPS + 1))
    tout = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=STEPS + 1))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes"] == jout["cache_bytes"]
    assert tout["cache_bytes_per_layer"] == jout["cache_bytes_per_layer"]
    assert tout["tokens_per_s"] > 0

    # logits after prefill and over the greedy run's decode steps, teacher
    # forced, through the JAX engine's jitted entries and the port's model
    jst = jm.init_decode_state(2, MAX_LEN)
    tst = tm.init_decode_state(2, MAX_LEN, "cpu")
    jl, jst = jeng._prefill(jp, {"tokens": jnp.asarray(toks)}, jst)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for i in range(STEPS):
        tok = jout["tokens"][:, i]
        jl, jst = jeng._decode(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.tensor(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert tst[0].host_length == PROMPT + STEPS


def test_quantized_cache_smaller_than_fp(weights):
    """The paper's memory claim at smoke size: the polar cache of the same
    batch is smaller than the fp cache (``tests/test_serve.py:34``)."""
    sizes = {}
    for method in ("polar", "none"):
        _, _, tm, tp = _models(weights, "jnp", method)
        sizes[method] = ServeEngine(tm, tp, max_len=MAX_LEN,
                                    device="cpu").generate(
            {"tokens": _prompts(tm.cfg.vocab_size)},
            GenerationConfig(max_new_tokens=2))["cache_bytes"]
    assert sizes["polar"] < sizes["none"]


def test_eos_masking_matches_jax(weights):
    jm, jp, tm, tp = _models(weights, "jnp", "polar")
    toks = _prompts(tm.cfg.vocab_size, seed=1)
    plain = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=10))["tokens"]
    eos = int(plain[0, 3])           # row 0 ends at its 4th token
    jout = JServe(jm, jp, max_len=MAX_LEN).generate(
        {"tokens": jnp.asarray(toks)}, JGen(max_new_tokens=10, eos_id=eos))
    tout = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=10, eos_id=eos))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    first = int(np.argmax(tout["tokens"][0] == eos))
    assert first <= 3 and (tout["tokens"][0, first:] == eos).all()


def test_temperature_sampling_matches_jax_with_shared_noise(weights):
    """JAX's categorical draw is Gumbel-max over the key schedule PRNGKey
    (seed), then one split per step; the port's ``_sample`` is fed the
    same Gumbel draws, so both engines pick the same tokens."""
    jm, jp, tm, tp = _models(weights, "jnp", "polar")
    toks = _prompts(tm.cfg.vocab_size, seed=2)
    jgen = JGen(max_new_tokens=8, temperature=0.8, top_k=20, seed=3)
    jout = JServe(jm, jp, max_len=MAX_LEN).generate(
        {"tokens": jnp.asarray(toks)}, jgen)
    shape = (2, tm.cfg.vocab_size)
    key = jax.random.PRNGKey(3)
    noise = [np.array(jax.random.gumbel(key, shape))]
    for _ in range(7):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.gumbel(sub, shape)))
    draws = iter(noise)
    sample = tcore._sample

    def fed(logits, gen, generator=None):
        return sample(logits, gen, noise=torch.from_numpy(next(draws)))

    with mock.patch.object(tcore, "_sample", fed):
        tout = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
            {"tokens": toks}, GenerationConfig(max_new_tokens=8,
                                               temperature=0.8, top_k=20,
                                               seed=3))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    # the port's own generator: the session seed fixes the stream
    gen = GenerationConfig(max_new_tokens=8, temperature=0.8, seed=3)
    eng = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu")
    a, b = (eng.generate({"tokens": toks}, gen)["tokens"] for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_capacity_check(weights):
    _, _, tm, tp = _models(weights, "jnp", "polar")
    eng = ServeEngine(tm, tp, max_len=60, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.generate({"tokens": _prompts(tm.cfg.vocab_size)},
                     GenerationConfig(max_new_tokens=12))


def _requests(cls, vocab, n=5):
    """The ``tests/test_continuous_batching.py`` workload as a burst."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (int(rng.integers(
        8, 50)),)).astype(np.int32), max_new_tokens=int(rng.integers(3, 12)))
            for i in range(n)]


@pytest.mark.parametrize("backend", ["jnp", "gathered"])
def test_engine_core_gathered_routes_match_jax(weights, backend):
    jm, jp, tm, tp = _models(weights, backend, "polar")
    vocab = tm.cfg.vocab_size
    jout = JEngine(jm, jp, max_slots=3, max_len=128).run(
        _requests(JRequest, vocab), JGen())
    tout = ContinuousBatchingEngine(tm, tp, max_slots=3, max_len=128,
                                    device="cpu").run(
        _requests(Request, vocab), GenerationConfig())
    assert {r.rid: r.out_tokens for r in tout["requests"]} == \
        {r.rid: r.out_tokens for r in jout["requests"]}

    def events(out):
        return [(e.kind, e.rid, e.slot, e.ordinal, e.token)
                for e in out["events"]]

    assert events(tout) == events(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
