"""Port parity: the dense KV cache of ``repro_torch`` (``core/kv_cache.py``)
and the paged cache's gathered view against the JAX package.

One token stream per codec — a prefill (one full group + a partial one)
then appends that cross two group flushes — must leave every buffer as
JAX leaves it: values, residual and length byte for byte, polar codes
exactly (a one-step flip would be allowed only within 4 ulp of a floor
boundary, ROADMAP queue 3; none occurs here), polar stats within 1e-6
(float32 sqrt/atan2 ulps of the two libraries). Decode attention over
the cache, on its score-only and fused routes, agrees within 1e-4 at ()
and (B,) lengths; ``gather_view`` reproduces JAX's dense view of a
fragmented page table with a NaN-poisoned scratch page."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import kv_cache as jkv  # noqa: E402
from repro.core import paged_cache as jpg  # noqa: E402
from repro.core.cache_layout import LinearLayout as JLinear  # noqa: E402
from repro.core.cache_layout import PageAllocator as JAlloc  # noqa: E402
from repro.core.cache_layout import PagedLayout as JPaged  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import kv_cache as tkv  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

B, H, D, G, CAP = 2, 2, 32, 16, 64
PROMPT, STEPS = 21, 30          # positions 21..50: flushes at 31 and 47
TOL = dict(rtol=1e-4, atol=1e-4)

_j_prefill = jax.jit(jkv.prefill)
_j_append = jax.jit(jkv.append)
_j_decode = jax.jit(jkv.decode_attention)
_j_fused = jax.jit(jkv.fused_decode_attention, static_argnames="backend")
_j_full = jax.jit(jops.polar_decode_attention_full,
                  static_argnames="backend")
_j_encode = jax.jit(jops.polar_encode,
                    static_argnames=("group_size", "backend"))
_j_gather = jax.jit(jpg.gather_view)
_j_paged_attn = jax.jit(jpg.paged_decode_attention,
                        static_argnames="backend")
_j_masks = jax.jit(jkv.position_masks, static_argnums=(0, 1, 3))


def t(x):
    return torch.from_numpy(np.array(x))


def _pair(method, rng_seed=0):
    """(JAX cache, port cache) after the same prefill + append stream."""
    rng = np.random.default_rng(rng_seed)
    k = rng.standard_normal((B, H, PROMPT, D)).astype(np.float32)
    v = rng.standard_normal((B, H, PROMPT, D)).astype(np.float32)
    ks = rng.standard_normal((STEPS, B, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((STEPS, B, H, 1, D)).astype(np.float32)
    jc = jkv.init_cache(JQuantConfig(method=method, group_size=G), B, H, D,
                        CAP, dtype=jnp.float32, layout=JLinear(CAP))
    tc = tkv.init_cache(QuantConfig(method=method, group_size=G), B, H, D,
                        CAP, dtype=torch.float32, device="cpu")
    jc = _j_prefill(jc, jnp.asarray(k), jnp.asarray(v))
    tkv.prefill(tc, t(k), t(v))
    for i in range(STEPS):
        jc = _j_append(jc, jnp.asarray(ks[i]), jnp.asarray(vs[i]))
        tkv.append(tc, t(ks[i]), t(vs[i]))
    return jc, tc


@pytest.fixture(scope="module", params=["polar", "none"])
def caches(request):
    return request.param, *_pair(request.param)


def test_stream_buffers_match_jax(caches):
    method, jc, tc = caches
    assert int(jc.length) == int(tc.length) == tc.host_length \
        == PROMPT + STEPS
    np.testing.assert_array_equal(tc.value_fp.numpy(),
                                  np.asarray(jc.value_fp))
    if method == "none":
        assert tc.key_residual is None and jc.key_residual is None
        assert tc.key_scales == {} and jc.key_scales == {}
        np.testing.assert_array_equal(tc.key_codes.numpy(),
                                      np.asarray(jc.key_codes))
        return
    assert tc.key_residual.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tc.key_residual.float().numpy(),
        np.asarray(jc.key_residual.astype(jnp.float32)))
    np.testing.assert_array_equal(tc.key_codes.numpy(),
                                  np.asarray(jc.key_codes))
    for name, buf in tc.key_scales.items():
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(jc.key_scales[name]),
                                   rtol=1e-6, atol=1e-6)
    # three groups written (prefill + two flushes), the fourth untouched
    assert tc.key_codes[:, :, :3].any() and not tc.key_codes[:, :, 3].any()


def test_bulk_prefill_equals_streamed_appends():
    """The streaming-parity invariant: prefill rounds keys through the
    residual dtype, so prefilling T tokens at once gives the codes of T
    appends."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((B, H, 40, D)).astype(np.float32)
    v = rng.standard_normal((B, H, 40, D)).astype(np.float32)
    cfg = QuantConfig(group_size=G)
    bulk = tkv.prefill(tkv.init_cache(cfg, B, H, D, CAP, dtype=torch.float32,
                                      device="cpu"), t(k), t(v))
    step = tkv.init_cache(cfg, B, H, D, CAP, dtype=torch.float32,
                          device="cpu")
    for i in range(40):
        tkv.append(step, t(k[:, :, i:i + 1]), t(v[:, :, i:i + 1]))
    assert torch.equal(bulk.key_codes, step.key_codes)
    for name in bulk.key_scales:
        assert torch.equal(bulk.key_scales[name], step.key_scales[name])
    assert torch.equal(bulk.key_residual[:, :, :8], step.key_residual[:, :, :8])
    assert torch.equal(bulk.value_fp, step.value_fp)


def test_append_past_capacity_raises():
    c = tkv.init_cache(QuantConfig(group_size=G), 1, 1, D, G,
                       dtype=torch.float32, device="cpu")
    x = torch.zeros((1, 1, G, D))
    tkv.prefill(c, x, x)
    with pytest.raises(ValueError, match="full"):
        tkv.append(c, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError, match="exceeds linear capacity"):
        tkv.prefill(c, torch.zeros((1, 1, G + 1, D)),
                    torch.zeros((1, 1, G + 1, D)))


@pytest.mark.parametrize("length", [0, 5, 16, 37, 64, [0, 17, 48, 64]])
def test_position_masks_match_jax(length):
    ln = np.asarray(length, np.int32)
    for g in (G, 1):
        jm = _j_masks(CAP, g, jnp.asarray(ln), 0)
        tm = tkv.position_masks(CAP, g, t(ln))
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _prefilled(method, length, seed=0):
    """Both caches prefilled with ``length`` fp keys/values (one row of
    ``tests/test_fused_decode.py:46``)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, H, length, D)).astype(np.float32)
    v = rng.standard_normal((B, H, length, D)).astype(np.float32)
    jc = jkv.init_cache(JQuantConfig(method=method, group_size=G), B, H, D,
                        CAP, dtype=jnp.float32, layout=JLinear(CAP))
    tc = tkv.init_cache(QuantConfig(method=method, group_size=G), B, H, D,
                        CAP, dtype=torch.float32, device="cpu")
    return _j_prefill(jc, jnp.asarray(k), jnp.asarray(v)), \
        tkv.prefill(tc, t(k), t(v))


@pytest.mark.parametrize("method", ["polar", "none"])
@pytest.mark.parametrize("length", [37, 48, 64])
def test_decode_attention_matches_jax(method, length):
    """Both routes at a () length, then the same buffers at per-row (B,)
    lengths (the gathered-view form)."""
    jc, tc = _prefilled(method, length)
    q = np.random.default_rng(9).standard_normal((B, 2 * H, D)).astype(
        np.float32)
    rows = np.array([length - 20, length], np.int32)
    for jl, tl in ((jc.length, tc.length), (jnp.asarray(rows), t(rows))):
        jcl = dataclasses.replace(jc, length=jl)
        tcl = dataclasses.replace(tc, length=tl, host_length=None)
        want = np.asarray(_j_decode(jcl, jnp.asarray(q)))
        np.testing.assert_allclose(
            tkv.decode_attention(tcl, t(q)).numpy(), want, **TOL)
        if method == "polar":
            np.testing.assert_allclose(
                tkv.fused_decode_attention(tcl, t(q)).numpy(),
                np.asarray(_j_fused(jcl, jnp.asarray(q), backend="ref")),
                **TOL)
            np.testing.assert_allclose(
                tkv.fused_decode_attention(tcl, t(q)).numpy(), want, **TOL)


def test_fused_decode_rejects_codec_without_kernel():
    _, tc = _prefilled("none", 20)
    with pytest.raises(ValueError, match="fused"):
        tkv.fused_decode_attention(tc, torch.zeros((B, 2 * H, D)))


def test_full_decode_per_row_lengths_match_jax():
    """``tests/test_fused_decode.py:28``: per-row (B,) lengths through
    ``polar_decode_attention_full`` against JAX's, and against per-row
    calls at () lengths."""
    b, hkv, qh, d, g, gc = 3, 2, 4, 32, 16, 4
    rng = np.random.default_rng(1)
    k = rng.standard_normal((b, hkv, gc * g, d)).astype(np.float32)
    q = rng.standard_normal((b, hkv * qh, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, gc * g, d)).astype(np.float32)
    res = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    enc = [np.asarray(x) for x in
           _j_encode(jnp.asarray(k), group_size=g, backend="ref")]
    lengths = np.array([7, 40, 64], np.int32)
    want = _j_full(
        jnp.asarray(q), *(jnp.asarray(x) for x in enc), jnp.asarray(res),
        jnp.asarray(v), None, None, jnp.asarray(lengths), backend="ref")
    got = ops.polar_decode_attention_full(
        t(q), *(t(x) for x in enc), t(res), t(v), t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(b):
        one = ops.polar_decode_attention_full(
            t(q[i:i + 1]), *(t(x[i:i + 1]) for x in enc), t(res[i:i + 1]),
            t(v[i:i + 1]), torch.tensor(int(lengths[i]), dtype=torch.int32))
        np.testing.assert_allclose(one[0].numpy(), got[i].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_cache_logical_bits_match_jax():
    for method in ("polar", "none"):
        jc, tc = _prefilled(method, 16)
        assert tkv.cache_logical_bits(tc) == jkv.cache_logical_bits(jc)


# ---------------------------------------------------------------------------
# gathered dense view of the paged cache
# ---------------------------------------------------------------------------

S, NP = 3, 12                   # slots, allocatable pages (+1 scratch)


def _paged_pair(dtype, prompts=(9, 38, 64)):
    """Both paged caches after one prefill per slot (slots at different
    lengths, the case of ``tests/test_fused_decode.py:63``), values in
    ``dtype``; the JAX allocator's table."""
    jlay = JPaged(page_size=G, num_pages=NP, slots=S, pages_per_slot=5)
    lay = PagedLayout(page_size=G, num_pages=NP, slots=S, pages_per_slot=5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = jpg.init_paged_cache(JQuantConfig(group_size=G), jlay, H, D,
                              dtype=jdt)
    tc = tpg.init_paged_cache(QuantConfig(group_size=G), lay, H, D,
                              dtype=dtype, device="cpu")
    alloc = JAlloc(jlay)
    alloc.alloc(0, 1)           # a page nobody maps: rows are fragmented
    rng = np.random.default_rng(2)
    prefill = jax.jit(jpg.paged_prefill)
    for slot, tl in enumerate(prompts):
        assert alloc.alloc(slot, jlay.pages_for(tl + 1))
        row = alloc.table_np()[slot]
        bucket = -(-tl // G) * G
        k = rng.standard_normal((1, H, bucket, D)).astype(np.float32)
        v = rng.standard_normal((1, H, bucket, D)).astype(np.float32)
        jc = prefill(jc, jnp.asarray(slot), jnp.asarray(row), jnp.asarray(k),
                     jnp.asarray(v), jnp.asarray(tl))
        tpg.paged_prefill(tc, slot, t(row), t(k), t(v), tl)
    return jc, tc, alloc.table_np()


def _poison_scratch(jc, tc):
    """NaN stats and value rows on the scratch page, in both caches."""
    sp = tc.layout.scratch_page
    for x in (*tc.key_scales.values(), tc.value_fp):
        x[sp] = float("nan")
    return dataclasses.replace(
        jc, key_scales={k: v.at[sp].set(jnp.nan)
                        for k, v in jc.key_scales.items()},
        value_fp=jc.value_fp.at[sp].set(jnp.nan)), tc


def test_gather_view_matches_jax_with_poisoned_scratch():
    jc, tc, table = _paged_pair(torch.float32)
    jc, tc = _poison_scratch(jc, tc)
    assert (table == NP).any()              # dead entries -> scratch
    jv = _j_gather(jc, jnp.asarray(table))
    tv = tpg.gather_view(tc, t(table))
    assert tv.max_len == jv.max_len and tv.host_length is None
    # the dense kernels take contiguous buffers
    for x in (tv.key_codes, *tv.key_scales.values(), tv.value_fp):
        assert x.is_contiguous()
    np.testing.assert_array_equal(tv.length.numpy(), np.asarray(jv.length))
    np.testing.assert_array_equal(tv.key_codes.numpy(),
                                  np.asarray(jv.key_codes))
    np.testing.assert_array_equal(tv.value_fp.numpy(),
                                  np.asarray(jv.value_fp))
    for name, buf in tv.key_scales.items():
        assert torch.isfinite(buf).all()
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(jv.key_scales[name]),
                                   rtol=1e-6, atol=1e-6)
    assert torch.isfinite(tv.value_fp).all()
    # a width-sliced (non-contiguous) table reads the same pages
    w = 4
    tw = tpg.gather_view(tc, t(table)[:, :w])
    assert torch.equal(tw.key_codes, tv.key_codes[:, :, :w])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_backends_match_jax_on_heterogeneous_slots(dtype):
    """``"jnp"``, ``"gathered"`` and ``"paged_fused"`` over slots at 9, 38
    and 64 tokens with a NaN scratch page, against JAX's ``"jnp"``
    reference, within 1e-4."""
    jc, tc, table = _paged_pair(dtype)
    jc, tc = _poison_scratch(jc, tc)
    q = np.random.default_rng(7).standard_normal((S, 2 * H, D)).astype(
        np.float32)
    want = np.asarray(_j_paged_attn(jc, jnp.asarray(q), jnp.asarray(table),
                                    backend="jnp"))
    for backend in tpg.DECODE_BACKENDS:
        got = tpg.paged_decode_attention(tc, t(q), t(table), backend=backend)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="unknown paged decode backend"):
        tpg.paged_decode_attention(tc, t(q), t(table), backend="ref")
