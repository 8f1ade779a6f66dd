"""Port parity for the paper's dense configurations at head_dim 128
(llama3.1-8b, granite-8b, yi-9b, qwen1.5-4b) beside tinyllama, the MoE
configurations (qwen2-moe-a2.7b, dbrx-132b), the VLM (paligemma-3b), the
hybrid (recurrentgemma-9b), the encoder-decoder (seamless-m4t-medium) and
the SSM (mamba2-2.7b).

Each port config equals its JAX config on every shared field, with the
same ``param_count``, the same shape suite and registry; then, on each
new config's smoke reduction with ``head_dim=128`` (qwen1.5 keeps MHA,
one query head per KV head, and non-zero q/k/v biases set in the JAX
params before they cross over), the port's continuous-batching engine
gives JAX's greedy streams and event sequences, and its prefill and
decode logits agree within 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.cache_layout import PageAllocator, PagedLayout  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base as cbase  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout as TLayout  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request,
)
from repro_torch.weights import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("granite-8b", "llama3.1-8b", "qwen1.5-4b", "tinyllama-1.1b",
         "yi-9b")
MOE = ("dbrx-132b", "qwen2-moe-a2.7b")
#: the static-only families (the VLM frontend, the RG-LRU hybrid, the
#: encoder-decoder, the SSM)
STATIC_ONLY = ("mamba2-2.7b", "paligemma-3b", "recurrentgemma-9b",
               "seamless-m4t-medium")
NEW = ("llama3.1-8b", "granite-8b", "yi-9b", "qwen1.5-4b")
#: fields the port's ModelConfig shares with JAX's whose values may differ
#: by design: the policy objects are each package's own classes, and the
#: port's backends default to the kernels' routes
_OWN = {"quant", "cache_policy", "decode_backend", "prefill_backend"}


def _shared_fields():
    ours = {f.name for f in dataclasses.fields(configs.ModelConfig)}
    theirs = {f.name for f in dataclasses.fields(jconfigs.ModelConfig)}
    assert ours <= theirs, ours - theirs
    return sorted(ours - _OWN)


@pytest.mark.parametrize("name", DENSE + MOE + STATIC_ONLY)
def test_config_matches_jax(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    for f in _shared_fields():
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.q_per_kv == jcfg.q_per_kv
    assert cfg.quant.group_size == jcfg.quant.group_size
    small, jsmall = (configs.reduce_for_smoke(cfg, head_dim=128),
                     jconfigs.reduce_for_smoke(jcfg, head_dim=128))
    for f in _shared_fields():
        assert getattr(small, f) == getattr(jsmall, f), f
    assert small.max_seq_len == 512
    assert small.quant.group_size == jsmall.quant.group_size == 32


def test_registry_and_shape_suite_match_jax():
    assert configs.list_configs() == sorted(DENSE + MOE + STATIC_ONLY)
    assert configs.list_configs() == jconfigs.list_configs()
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(configs.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ShapeConfig)]
    for name in MOE + STATIC_ONLY:
        assert configs.get_config(name).param_count() == \
            jconfigs.get_config(name).param_count()
    # every family's branch of param_count, JAX's values (gaps included)
    for family in ("ssm", "encdec"):
        assert dataclasses.replace(configs.get_config("yi-9b"),
                                   family=family).param_count() == \
            dataclasses.replace(jconfigs.get_config("yi-9b"),
                                family=family).param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("mamba2-1.3b")
    assert cbase.get_config("qwen1.5-4b").qkv_bias
    assert [configs.get_config(n).rope_base for n in NEW] == \
        [500000.0, 10000.0, 10000.0, 1000000.0]
    assert [configs.get_config(n).vocab_size for n in NEW] == \
        [128256, 49152, 64000, 151936]


# ---------------------------------------------------------------------------
# the smoke reductions at head_dim 128 through the model and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NEW)
def pair(request):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)
    of one config's smoke reduction at head_dim 128, on the page-native
    backends; qwen1.5's q/k/v biases drawn non-zero before crossing."""
    name = request.param
    jcfg = dataclasses.replace(
        jconfigs.reduce_for_smoke(jconfigs.get_config(name), head_dim=128),
        decode_backend="paged_fused", prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(11)
        attn = jp["layers"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(
                np.float32)
    cfg = configs.reduce_for_smoke(configs.get_config(name), head_dim=128)
    tp = params_from_jax(jp, cfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    return jcfg, jm, jp, cfg, get_model(cfg), tp


def test_smoke_shapes(pair):
    jcfg, _, _, cfg, _, tp = pair
    assert cfg.head_dim == jcfg.head_dim == 128
    assert cfg.num_kv_heads == jcfg.num_kv_heads
    if cfg.qkv_bias:   # qwen1.5: MHA, one query head per kv head
        assert cfg.q_per_kv == 1
        assert all(float(layer["attn"][b].abs().min()) > 0
                   for layer in tp["layers"] for b in ("bq", "bk", "bv"))


def _buffers(state):
    """Every buffer of a paged state, per layer: the port's list of caches
    or JAX's layer-stacked segment, as numpy (bf16 widened to fp32)."""
    names = ("key_codes", "key_residual", "value_fp", "lengths")
    if isinstance(state, list):
        out = []
        for c in state:
            bufs = {n: getattr(c, n) for n in names}
            bufs.update(c.key_scales)
            out.append({n: x.float().numpy() if x.dtype == torch.bfloat16
                        else x.numpy() for n, x in bufs.items()})
        return out
    (seg,) = state
    bufs = {n: getattr(seg, n) for n in names}
    bufs.update(seg.key_scales)
    return [{n: np.asarray(x[i].astype(jnp.float32)
                           if x.dtype == jnp.bfloat16 else x[i])
             for n, x in bufs.items()} for i in range(len(bufs["lengths"]))]


def _check_states(tstate, jstate, scratch):
    """The port's state against JAX's after the same prefill: codes and
    lengths equal; stats and values within 1e-4 (the attention
    tolerance): from the second layer on the keys differ by the float32
    rounding of the layer below, and an angle stat set by a short pair
    moves by more than ulps (granite and yi, seed 3: 2e-5 relative); the
    bf16 residual keys within one bf16 step (2^-7 relative), since keys
    that differ by float32 ulps may land on either side of a bf16
    rounding boundary. The scratch page is left out (JAX writes dead rows
    there)."""
    for t, j in zip(_buffers(tstate), _buffers(jstate)):
        for n in t:
            a, b = t[n], j[n]
            if n not in ("key_residual", "lengths"):
                a, b = np.delete(a, scratch, 0), np.delete(b, scratch, 0)
            if n in ("key_codes", "lengths"):
                np.testing.assert_array_equal(a, b, err_msg=n)
            elif n == "key_residual":
                np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6,
                                           err_msg=n)
            else:
                np.testing.assert_allclose(a, b, err_msg=n, **TOL)


def _load_state(tstate, jstate):
    """Copy JAX's state into the port's, in place."""
    for c, bufs in zip(tstate, _buffers(jstate)):
        for n, x in bufs.items():
            dst = c.key_scales[n] if n in c.key_scales else getattr(c, n)
            dst.copy_(torch.from_numpy(np.array(x)).to(dst.dtype))


def test_prefill_and_decode_logits_match_jax(pair):
    """Two slots prefilled (40 and 17 tokens), then 16 teacher-forced
    batched decode steps crossing a group boundary. Prefill logits within
    1e-4 and the caches held to JAX's (:func:`_check_states`); every
    decode step then runs from JAX's state on both sides and its logits
    agree within 1e-4. A step's own appends are not held to JAX's: a key
    that rounds to the other bf16 neighbour moves the stats of the group
    it flushes into by more than ulps (granite and yi, seed 3)."""
    jcfg, jm, jp, cfg, tm, tp = pair
    g = cfg.quant.group_size
    lay = dict(page_size=g, num_pages=12, slots=2, pages_per_slot=4)
    alloc = PageAllocator(PagedLayout(**lay))
    jstate = jm.init_paged_state(PagedLayout(**lay))
    tstate = tm.init_paged_state(TLayout(**lay), "cpu")
    rng = np.random.default_rng(3)
    steps = 16
    for slot, tl in ((0, 40), (1, 17)):
        assert alloc.alloc(slot, -(-(tl + steps) // g))
        toks = rng.integers(0, cfg.vocab_size, (1, 64)).astype(np.int32)
        row = alloc.table_np()[slot]
        jl, jstate = jm.prefill_paged(jp, jnp.asarray(toks), jstate,
                                      jnp.asarray(slot, jnp.int32),
                                      jnp.asarray(row),
                                      jnp.asarray(tl, jnp.int32))
        tl_, _ = tm.prefill_paged(tp, torch.from_numpy(toks).long(), tstate,
                                  slot, torch.from_numpy(row), tl)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    _check_states(tstate, jstate, lay["num_pages"])
    table = alloc.table_np()
    jdecode = jax.jit(jm.decode_paged)
    feed = rng.integers(0, cfg.vocab_size, (steps, 2)).astype(np.int32)
    for i in range(steps):
        _load_state(tstate, jstate)
        jl, jstate = jdecode(jp, jstate, jnp.asarray(feed[i]),
                             jnp.asarray(table), jnp.ones((2,), bool))
        tl_, _ = tm.decode_paged(tp, tstate, torch.from_numpy(feed[i]).long(),
                                 torch.from_numpy(table),
                                 torch.ones((2,), dtype=torch.bool))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)


def _requests(cls, vocab, n=5, seed=0):
    """A burst (every arrival at t = 0: the engine clock is measured
    compute time) of ``n`` greedy requests, prompts 8-50 tokens."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, (int(rng.integers(8, 50)),))
                .astype(np.int32),
                max_new_tokens=int(rng.integers(3, 12))) for i in range(n)]


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token)
            for e in out["events"]]


def _engines_match(pair, reqs, **kw):
    jcfg, jm, jp, cfg, tm, tp = pair
    jout = JEngine(jm, jp, **kw).run(reqs(JRequest), JGen())
    tout = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    assert {r.rid: r.out_tokens for r in tout["requests"]} == \
        {r.rid: r.out_tokens for r in jout["requests"]}
    assert _events(tout) == _events(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
    return jout, tout


def test_engine_streams_and_events_match_jax(pair):
    """The classic engine on each config: identical greedy streams and
    events."""
    vocab = pair[3].vocab_size
    _engines_match(pair, lambda cls: _requests(cls, vocab), max_slots=3,
                   max_len=128)


# granite-8b's and yi-9b's smoke reductions are llama3.1-8b's shapes at
# another rope base, so the chunked run takes llama3.1-8b (GQA, rope
# 5e5) and qwen1.5-4b (one query head per kv head, biases)
@pytest.mark.parametrize("pair", ["llama3.1-8b", "qwen1.5-4b"],
                         indirect=True)
def test_prefix_engine_streams_and_events_match_jax(pair):
    """Chunked prefill over the prefix cache, a shared 64-token prompt
    head so later admissions adopt pages: identical greedy streams,
    events and adopted pages."""
    vocab = pair[3].vocab_size
    head = np.random.default_rng(5).integers(0, vocab, (64,)).astype(
        np.int32)

    def reqs(cls):
        out = _requests(cls, vocab, n=4, seed=6)
        for r in out:
            r.prompt = np.concatenate([head, r.prompt])
        return out
    jout, tout = _engines_match(pair, reqs, max_slots=3, max_len=128,
                                prefix_cache=True, prefill_chunk=32)
    assert tout["adopted_pages"] == jout["adopted_pages"] > 0


@pytest.mark.parametrize("name", STATIC_ONLY)
def test_static_only_param_counts_and_smoke_reductions_match_jax(name):
    """paligemma-3b (with its patch projector), recurrentgemma-9b (RG-LRU
    layers beside the local-attention ones, 38 = 12 periods + a 2-layer
    tail), seamless-m4t-medium (12 encoder + 12 decoder layers, MHA at
    head_dim 64) and mamba2-2.7b (attention-free) count JAX's parameters,
    whole and in the smoke reduction, which keeps a one-layer tail for
    the hybrid, 2 + 2 layers for the encoder-decoder and JAX's SSD sizes
    for the SSM."""
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert cfg.param_count() == jcfg.param_count()
    small, jsmall = configs.reduce_for_smoke(cfg), \
        jconfigs.reduce_for_smoke(jcfg)
    for f in _shared_fields():
        assert getattr(small, f) == getattr(jsmall, f), f
    assert small.param_count() == jsmall.param_count()
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    if cfg.family == "ssm":
        assert (cfg.d_model, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_chunk,
                cfg.head_dim) == (2560, 128, 64, 256, 0)
        assert (small.ssm_state, small.ssm_headdim, small.ssm_chunk) == \
            (16, 16, 32)
        assert cfg.sub_quadratic and cfg.tie_embeddings
        return
    if cfg.family == "encdec":
        assert (cfg.head_dim, cfg.num_kv_heads, cfg.encoder_layers) == \
            (64, 16, 12)
        assert (small.encoder_layers, small.frontend_dim,
                small.frontend_tokens) == (2, 32, 16)
        assert not cfg.sub_quadratic
        return
    assert cfg.head_dim == 256 and cfg.num_kv_heads == 1
    if cfg.family == "hybrid":
        assert small.num_layers == len(cfg.block_pattern) + 1
        assert (small.window, small.lru_width) == (64, 128)
        assert cfg.sub_quadratic == jcfg.sub_quadratic is True
    else:
        assert (small.frontend_dim, small.frontend_tokens) == (32, 16)
        assert cfg.param_count() - dataclasses.replace(
            cfg, family="dense").param_count() == 1152 * 2048
