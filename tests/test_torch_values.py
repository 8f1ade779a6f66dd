"""Port parity with quantized values (``QuantConfig(value_bits=4)``: uint8
mid-tread codes with one fp32 scale and zero per (token, kv head) row)
against the JAX package.

* The dense and paged caches: prefill, append, ``gather_view`` and the COW
  page copy leave the value buffers as JAX leaves them (codes at most one
  step apart — both round (v - min) / scale half to even in float32 — and
  scales and zeros within 1e-6); decode attention on both dense routes and
  all three paged backends agrees within 1e-4.
* The plain versions of kernels #2, #4 and #5 with ``vscale`` / ``vzero``
  against JAX's interpret-mode Pallas kernels, with a NaN-poisoned scratch
  page and, for #5, NaN past each row's length (where JAX's kernel
  multiplies dead rows by p = 0 and returns NaN: pinned, ROADMAP queue 3).
* The engines at smoke size: ``EngineCore`` classic and chunked with the
  prefix cache, and ``ServeEngine`` on both decode routes, give the JAX
  engines' greedy streams and event sequences (workloads of
  ``tests/test_torch_serve.py``, ``tests/test_torch_prefix_cache.py`` and
  ``tests/test_torch_static_serve.py``), and the cache shrinks polar+v4 <
  polar < fp (``tests/test_serve.py:37``).

Inputs come from numpy; tolerance rtol = atol = 1e-4 in fp32."""
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
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import kv_cache as jkv  # noqa: E402
from repro.core import paged_cache as jpg  # noqa: E402
from repro.core.cache_layout import LinearLayout as JLinear  # noqa: E402
from repro.core.cache_layout import PageAllocator as JAlloc  # noqa: E402
from repro.core.cache_layout import PagedLayout as JPaged  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import kv_cache as tkv  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import paged_prefill as ppk  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.utils import tree_bytes  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

B, H, D, G, CAP = 2, 2, 32, 16, 64
PROMPT, STEPS = 21, 30          # positions 21..50: flushes at 31 and 47
VB = 4
TOL = dict(rtol=1e-4, atol=1e-4)
VALUE_FIELDS = ("value_codes", "value_scale", "value_zero")

_j_prefill = jax.jit(jkv.prefill)
_j_append = jax.jit(jkv.append)
_j_decode = jax.jit(jkv.decode_attention)
_j_fused = jax.jit(jkv.fused_decode_attention, static_argnames="backend")
_j_gather = jax.jit(jpg.gather_view)
_j_paged_attn = jax.jit(jpg.paged_decode_attention,
                        static_argnames="backend")
_j_encode = jax.jit(jops.polar_encode,
                    static_argnames=("group_size", "backend"))


def t(x):
    return torch.from_numpy(np.array(x))


def _assert_values_match(tc, jc):
    """Value buffers: codes at most one step apart, scales and zeros within
    1e-6; no fp rows on either side."""
    assert tc.value_fp is None and jc.value_fp is None
    codes = tc.value_codes.numpy().astype(np.int32)
    assert tc.value_codes.dtype == torch.uint8
    assert np.abs(codes - np.asarray(jc.value_codes, np.int32)).max() <= 1
    for f in VALUE_FIELDS[1:]:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# dense cache
# ---------------------------------------------------------------------------


def _dense_pair(seed=0):
    """(JAX cache, port cache) after the same prefill + append stream."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, H, PROMPT, D)).astype(np.float32)
    v = rng.standard_normal((B, H, PROMPT, D)).astype(np.float32)
    ks = rng.standard_normal((STEPS, B, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((STEPS, B, H, 1, D)).astype(np.float32)
    jc = jkv.init_cache(JQuantConfig(group_size=G, value_bits=VB), B, H, D,
                        CAP, dtype=jnp.float32, layout=JLinear(CAP))
    tc = tkv.init_cache(QuantConfig(group_size=G, value_bits=VB), B, H, D,
                        CAP, dtype=torch.float32, device="cpu")
    jc = _j_prefill(jc, jnp.asarray(k), jnp.asarray(v))
    tkv.prefill(tc, t(k), t(v))
    for i in range(STEPS):
        jc = _j_append(jc, jnp.asarray(ks[i]), jnp.asarray(vs[i]))
        tkv.append(tc, t(ks[i]), t(vs[i]))
    return jc, tc


@pytest.fixture(scope="module")
def dense():
    return _dense_pair()


def test_dense_value_buffers_match_jax(dense):
    jc, tc = dense
    assert tc.host_length == int(jc.length) == PROMPT + STEPS
    _assert_values_match(tc, jc)
    assert tc.value_scale.shape == (B, H, CAP, 1)
    # rows past the stream stay zero; the keys are untouched by values
    assert not tc.value_codes[:, :, PROMPT + STEPS:].any()
    np.testing.assert_array_equal(tc.key_codes.numpy(),
                                  np.asarray(jc.key_codes))
    assert tree_bytes(tc) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jc))
    assert tkv.cache_logical_bits(tc) == jkv.cache_logical_bits(jc)


def test_dense_decode_routes_match_jax(dense):
    """Score-only and fused routes at the () length, then the same buffers
    at per-row (B,) lengths (the gathered-view form)."""
    jc, tc = dense
    q = np.random.default_rng(9).standard_normal((B, 2 * H, D)).astype(
        np.float32)
    rows = np.array([PROMPT + 3, PROMPT + STEPS], np.int32)
    for jl, tl in ((jc.length, tc.length), (jnp.asarray(rows), t(rows))):
        jcl = dataclasses.replace(jc, length=jl)
        tcl = dataclasses.replace(tc, length=tl, host_length=None)
        want = np.asarray(_j_decode(jcl, jnp.asarray(q)))
        np.testing.assert_allclose(tkv.decode_attention(tcl, t(q)).numpy(),
                                   want, **TOL)
        fused = tkv.fused_decode_attention(tcl, t(q)).numpy()
        np.testing.assert_allclose(fused, want, **TOL)
        np.testing.assert_allclose(
            fused, np.asarray(_j_fused(jcl, jnp.asarray(q), backend="ref")),
            **TOL)


def test_bulk_prefill_equals_streamed_appends_with_value_codes():
    rng = np.random.default_rng(5)
    k = rng.standard_normal((B, H, 40, D)).astype(np.float32)
    v = rng.standard_normal((B, H, 40, D)).astype(np.float32)
    cfg = QuantConfig(group_size=G, value_bits=VB)
    bulk = tkv.prefill(tkv.init_cache(cfg, B, H, D, CAP, dtype=torch.float32,
                                      device="cpu"), t(k), t(v))
    step = tkv.init_cache(cfg, B, H, D, CAP, dtype=torch.float32,
                          device="cpu")
    for i in range(40):
        tkv.append(step, t(k[:, :, i:i + 1]), t(v[:, :, i:i + 1]))
    for f in VALUE_FIELDS:
        assert torch.equal(getattr(bulk, f), getattr(step, f))


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

S, NP = 3, 12                   # slots, allocatable pages (+1 scratch)


def _paged_pair(prompts=(9, 38, 64), appends=5):
    """Both paged caches after one prefill per slot on a fragmented table,
    then ``appends`` decode appends with slot 1 inactive on the last two;
    the JAX allocator's table."""
    jlay = JPaged(page_size=G, num_pages=NP, slots=S, pages_per_slot=6)
    lay = PagedLayout(page_size=G, num_pages=NP, slots=S, pages_per_slot=6)
    jc = jpg.init_paged_cache(JQuantConfig(group_size=G, value_bits=VB),
                              jlay, H, D, dtype=jnp.float32)
    tc = tpg.init_paged_cache(QuantConfig(group_size=G, value_bits=VB), lay,
                              H, D, dtype=torch.float32, device="cpu")
    alloc = JAlloc(jlay)
    alloc.alloc(0, 1)           # a page nobody maps: rows are fragmented
    rng = np.random.default_rng(2)
    prefill = jax.jit(jpg.paged_prefill)
    for slot, tl in enumerate(prompts):
        assert alloc.alloc(slot, jlay.pages_for(tl + appends))
        row = alloc.table_np()[slot]
        bucket = -(-tl // G) * G
        k = rng.standard_normal((1, H, bucket, D)).astype(np.float32)
        v = rng.standard_normal((1, H, bucket, D)).astype(np.float32)
        jc = prefill(jc, jnp.asarray(slot), jnp.asarray(row), jnp.asarray(k),
                     jnp.asarray(v), jnp.asarray(tl))
        tpg.paged_prefill(tc, slot, t(row), t(k), t(v), tl)
    table = alloc.table_np()
    append = jax.jit(jpg.paged_append)
    for i in range(appends):
        kn = rng.standard_normal((S, H, 1, D)).astype(np.float32)
        vn = rng.standard_normal((S, H, 1, D)).astype(np.float32)
        active = np.array([True, i < appends - 2, True])
        jc = append(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
                    jnp.asarray(active))
        tpg.paged_append(tc, t(kn), t(vn), t(table), t(active))
    return jc, tc, table


def _poison_scratch(jc, tc):
    """NaN key stats, value scales and zeros on the scratch page, and the
    largest value code there, in both caches."""
    sp = tc.layout.scratch_page
    for x in (*tc.key_scales.values(), tc.value_scale, tc.value_zero):
        x[sp] = float("nan")
    tc.value_codes[sp] = 255
    return dataclasses.replace(
        jc, key_scales={k: v.at[sp].set(jnp.nan)
                        for k, v in jc.key_scales.items()},
        value_scale=jc.value_scale.at[sp].set(jnp.nan),
        value_zero=jc.value_zero.at[sp].set(jnp.nan),
        value_codes=jc.value_codes.at[sp].set(255)), tc


@pytest.fixture(scope="module")
def paged():
    return _paged_pair()


def test_paged_pools_match_jax_after_prefill_and_appends(paged):
    jc, tc, _ = paged
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    sp = tc.layout.scratch_page
    # the scratch page takes inactive slots' writes in both; compare the
    # pages a slot owns
    live = [i for i in range(NP) if i != sp]
    for f in VALUE_FIELDS:
        getattr(tc, f)[sp] = 0
    jc = dataclasses.replace(jc, **{f: getattr(jc, f).at[sp].set(0)
                                    for f in VALUE_FIELDS})
    _assert_values_match(tc, jc)
    np.testing.assert_array_equal(tc.key_codes.numpy()[live],
                                  np.asarray(jc.key_codes)[live])
    assert tpg.pool_page_bytes(tc) == jpg.pool_page_bytes(jc)


def test_gather_view_and_paged_backends_match_jax(paged):
    jc, tc, table = paged
    jc, tc = _poison_scratch(jc, tc)
    assert (table == NP).any()              # dead entries -> scratch
    jv = _j_gather(jc, jnp.asarray(table))
    tv = tpg.gather_view(tc, t(table))
    for f in VALUE_FIELDS:
        x = getattr(tv, f)
        assert x.is_contiguous() and torch.isfinite(x.float()).all()
    _assert_values_match(tv, jv)
    q = np.random.default_rng(7).standard_normal((S, 2 * H, D)).astype(
        np.float32)
    want = np.asarray(_j_paged_attn(jc, jnp.asarray(q), jnp.asarray(table),
                                    backend="jnp"))
    for backend in tpg.DECODE_BACKENDS:
        got = tpg.paged_decode_attention(tc, t(q), t(table), backend=backend)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cow_copy_carries_value_pools_like_jax(paged):
    jc, tc, table = paged
    src, dst = int(table[2, 0]), int(table[0, 0])
    jc = jax.jit(jpg.copy_pool_pages)(jc, jnp.asarray(src), jnp.asarray(dst))
    tpg.copy_pool_pages(tc, src, dst)
    for f in VALUE_FIELDS:
        assert torch.equal(getattr(tc, f)[dst], getattr(tc, f)[src])
    _assert_values_match(*(dataclasses.replace(
        c, **{f: getattr(c, f)[dst] for f in VALUE_FIELDS}) for c in (tc, jc)))


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX's interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

PP = NP + 1


def _pool_inputs(seed):
    """Page pools from JAX's encode (keys) and value codes (fp32 rows
    quantized by the port), as numpy; the NaN-poisoned scratch page last."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((1, PP * H, G, D)).astype(np.float32)
    enc = [np.array(x).reshape(PP, H, *x.shape[-2:]) for x in
           _j_encode(jnp.asarray(k), group_size=G, backend="ref")]
    v = t(rng.standard_normal((PP, H, G, D)).astype(np.float32))
    qv = tkv.value_fields(QuantConfig(value_bits=VB), v)
    vals = [qv[f].numpy().copy() for f in VALUE_FIELDS]
    for x in (*enc[1:], *vals[1:]):
        x[NP] = np.nan
    vals[0][NP] = 255
    return enc, vals


def test_paged_decode_plain_u8_matches_jax_interpret():
    """Kernel #2's plain version with uint8 values; dead table entries on
    the NaN scratch page."""
    enc, vals = _pool_inputs(11)
    rng = np.random.default_rng(12)
    q = rng.standard_normal((S, H, 4, D)).astype(np.float32) * D ** -0.5
    table = np.full((S, 5), NP, np.int32)
    table[0, :3] = [7, 2, 10]
    table[2, :4] = [0, 5, 3, 8]
    flushed = np.array([3 * G, 0, 4 * G], np.int32)
    want = jops.polar_paged_decode_attention_grouped(
        jnp.asarray(q), *(jnp.asarray(x) for x in enc),
        *(jnp.asarray(x) for x in vals), jnp.asarray(table),
        jnp.asarray(flushed), backend="interpret")
    got = pdk.polar_paged_decode_grouped(
        t(q), *(t(x) for x in enc), t(vals[0]), t(table), t(flushed),
        vscale=t(vals[1]), vzero=t(vals[2]))
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_dense_decode_plain_u8_matches_jax_interpret():
    """Kernel #5's plain version with uint8 values at ragged row lengths:
    equal to JAX's interpret-mode kernel on clean rows; with NaN scales and
    zeros past each row's length the port stays finite and unchanged,
    while JAX's kernel returns NaN for the rows whose live groups hold the
    poison (ROADMAP queue 3)."""
    b, qh, gc = 3, 4, 4
    rng = np.random.default_rng(13)
    k = rng.standard_normal((b, H, gc * G, D)).astype(np.float32)
    enc = [np.array(x) for x in
           _j_encode(jnp.asarray(k), group_size=G, backend="ref")]
    qv = tkv.value_fields(QuantConfig(value_bits=VB), t(
        rng.standard_normal((b, H, gc * G, D)).astype(np.float32)))
    vals = [qv[f].numpy().copy() for f in VALUE_FIELDS]
    q = rng.standard_normal((b, H, qh, D)).astype(np.float32) * D ** -0.5
    length = np.array([0, 23, 64], np.int32)
    jin = [jnp.asarray(x) for x in (q, *enc)]
    want = jops.polar_decode_attention_grouped(
        *jin, *(jnp.asarray(x) for x in vals), jnp.asarray(length),
        backend="interpret", block_groups=2)
    clean = pak.polar_decode_attention_grouped(
        t(q), *(t(x) for x in enc), t(vals[0]), t(length),
        vscale=t(vals[1]), vzero=t(vals[2]))
    for a, w in zip(clean, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    for i, n in enumerate(length):
        vals[1][i, :, n:] = np.nan
        vals[2][i, :, n:] = np.nan
    got = pak.polar_decode_attention_grouped(
        t(q), *(t(x) for x in enc), t(vals[0]), t(length),
        vscale=t(vals[1]), vzero=t(vals[2]))
    for a, c in zip(got, clean):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)
    poisoned = jops.polar_decode_attention_grouped(
        *jin, *(jnp.asarray(x) for x in vals), jnp.asarray(length),
        backend="interpret", block_groups=2)
    assert np.isnan(np.asarray(poisoned[0])[1]).any()


def test_paged_prefill_plain_u8_matches_jax_interpret():
    """Kernel #4's plain version with uint8 prefix values on a fragmented
    row, a ragged fp chunk, dead entries on the NaN scratch page and NaN
    scales and zeros on the page at ``start``."""
    enc, vals = _pool_inputs(14)
    rng = np.random.default_rng(15)
    tc_, qpk = 16, 2
    q = rng.standard_normal((1, H * qpk, tc_, D)).astype(np.float32)
    kc = rng.standard_normal((1, H, tc_, D)).astype(np.float32)
    vc = rng.standard_normal((1, H, tc_, D)).astype(np.float32)
    row = np.array([9, 0, 5, 1, NP, NP], np.int32)
    start, clen = 3 * G, 11
    want = np.asarray(jops.polar_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        *(jnp.asarray(x) for x in enc), *(jnp.asarray(x) for x in vals),
        jnp.asarray(row), jnp.asarray(start, jnp.int32),
        jnp.asarray(clen, jnp.int32), backend="interpret"))
    for x in vals[1:]:
        x[row[3]] = np.nan                # page 3 starts at `start`: dead
    kc[:, :, clen:] = np.nan
    vc[:, :, clen:] = np.nan
    qf = torch.from_numpy(q * D ** -0.5).reshape(H, qpk * tc_, D)
    got = ppk.polar_paged_prefill_grouped(
        qf, t(kc[0]), t(vc[0]), *(t(x) for x in enc), t(vals[0]), t(row),
        start, clen, vscale=t(vals[1]), vzero=t(vals[2]))
    got = got.reshape(1, H * qpk, tc_, D).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :, :clen], want[:, :, :clen], **TOL)


def test_cpu_tensors_never_count_launches_with_u8_values():
    before = (pdk.launches, ppk.launches, ppk.launches_mma, pak.launches)
    test_paged_decode_plain_u8_matches_jax_interpret()
    test_paged_prefill_plain_u8_matches_jax_interpret()
    assert (pdk.launches, ppk.launches, ppk.launches_mma,
            pak.launches) == before


# ---------------------------------------------------------------------------
# engines at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduce(j_get_config("tinyllama-1.1b"))
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _models(weights, value_bits=VB, method="polar", backend="paged_fused"):
    """(JAX model, JAX params, port model, port params) under the policy;
    JAX's chunk prefill on its page-native route, as the port's."""
    jcfg, jp, cfg, tp = weights

    def cfg_of(c, **extra):
        return dataclasses.replace(
            c, decode_backend=backend, **extra,
            quant=dataclasses.replace(c.quant, method=method,
                                      value_bits=value_bits))

    return (j_get_model(cfg_of(jcfg, prefill_backend="paged_fused")), jp,
            get_model(cfg_of(cfg)), tp)


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token)
            for e in out["events"]]


def _streams(out):
    return {r.rid: list(r.out_tokens) for r in out["requests"]}


def _burst(cls, vocab, n=5):
    """``tests/test_continuous_batching.py``'s workload as a burst."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (int(rng.integers(
        8, 50)),)).astype(np.int32), max_new_tokens=int(rng.integers(3, 12)))
            for i in range(n)]


def _shared_prefix(cls, vocab):
    """``tests/test_paged_prefill.py:250``: a 96-token shared prefix plus
    8-40-token tails, the later requests arriving once the first is
    registered."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, (96,)).astype(np.int32)
    tails = [rng.integers(0, vocab, (int(rng.integers(8, 40)),))
             .astype(np.int32) for _ in range(5)]
    return [cls(rid=i, prompt=np.concatenate([shared, tails[i]]),
                max_new_tokens=6, arrival_time=0.0 if i == 0 else 1000.0)
            for i in range(5)]


@pytest.mark.parametrize("mode", ["classic", "chunked_prefix"])
def test_engine_core_streams_and_events_match_jax(weights, mode):
    jm, jp, tm, tp = _models(weights)
    vocab = tm.cfg.vocab_size
    if mode == "classic":
        make, kw = _burst, dict(max_slots=3, max_len=128)
    else:
        make, kw = _shared_prefix, dict(max_slots=3, max_len=192,
                                        prefill_chunk=32, prefix_cache=True)
    jout = JEngine(jm, jp, **kw).run(make(JRequest, vocab), JGen())
    tout = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(
        make(Request, vocab), GenerationConfig())
    assert _streams(tout) == _streams(jout)
    assert _events(tout) == _events(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
    if mode == "chunked_prefix":
        assert tout["adopted_pages"] == jout["adopted_pages"] > 0
        assert tout["cow_splits"] == jout["cow_splits"] == 0
        assert tout["pool_page_bytes"] == jout["pool_page_bytes"]


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_matches_jax(weights, backend):
    jm, jp, tm, tp = _models(weights, backend=backend)
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 50)).astype(np.int32)
    jout = JServe(jm, jp, max_len=128).generate(
        {"tokens": jnp.asarray(toks)}, JGen(max_new_tokens=17))
    tout = ServeEngine(tm, tp, max_len=128, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=17))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes"] == jout["cache_bytes"]
    assert tout["cache_bytes_per_layer"] == jout["cache_bytes_per_layer"]


def test_quantized_values_shrink_the_cache(weights):
    """``tests/test_serve.py:37``: polar+v4 < polar < fp cache bytes."""
    sizes = {}
    for name, method, vb in (("fp", "none", 0), ("polar", "polar", 0),
                             ("polar+v4", "polar", VB)):
        _, _, tm, tp = _models(weights, value_bits=vb, method=method,
                               backend="jnp")
        sizes[name] = ServeEngine(tm, tp, max_len=128, device="cpu").generate(
            {"tokens": np.zeros((2, 32), np.int32)},
            GenerationConfig(max_new_tokens=2))["cache_bytes"]
    assert sizes["polar+v4"] < sizes["polar"] < sizes["fp"]
