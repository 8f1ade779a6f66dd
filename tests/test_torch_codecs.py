"""Port parity: the baseline key codecs (``int``, ``kivi``, ``zipcache``,
the fp passthrough ``none``), the fixed angle grid of ``polar`` and SnapKV
eviction of ``repro_torch`` against the JAX package, on the CPU at small
shapes with numpy-seeded inputs.

Tolerances: mid-tread codes within one step (a float32 division of the
two libraries may round a ``.5`` the other way), scales, zeros and norms
within 1e-6; polar fixed-grid codes exactly equal except within 4 ulp of
a floor boundary (``test_torch_quantizers.py``'s allowance); attention
outputs within 1e-4. Also the port's dispatch guard: no string dispatch
on ``.method`` anywhere in ``src/repro_torch`` outside
``core/codecs.py`` (the counterpart of ``scripts/check_codec_dispatch.sh``,
which scans the JAX package)."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import eviction as jev  # noqa: E402
from repro.core import kv_cache as jkv  # noqa: E402
from repro.core import paged_cache as jpg  # noqa: E402
from repro.core import polar as jpolar  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.core.cache_layout import LinearLayout as JLinear  # noqa: E402
from repro.core.cache_layout import PageAllocator as JAlloc  # noqa: E402
from repro.core.cache_layout import PagedLayout as JLayout  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import eviction as tev  # noqa: E402
from repro_torch.core import kv_cache as tkv  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core import quantizers as tq  # noqa: E402
from repro_torch.core.cache_layout import PageAllocator, PagedLayout  # noqa: E402
from test_torch_quantizers import _prefloor_ok  # noqa: E402

BASELINES = ("int", "kivi", "zipcache")
CODECS = ("none", "int", "kivi", "zipcache", "polar")
H, D, G = 2, 32, 16
# the JAX cache steps jitted (op-by-op dispatch of a step costs more than
# its compile here)
_j_append = jax.jit(jkv.append)
_j_paged_append = jax.jit(jpg.paged_append)
_j_span_verify = jax.jit(jpg.span_verify_attention)


def _qcfgs(method, **kw):
    """The same QuantConfig in both packages."""
    return jq.QuantConfig(method=method, **kw), tq.QuantConfig(method=method,
                                                               **kw)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close_codes(tc, jc, steps=1):
    d = np.abs(_np(tc).astype(np.int64) - _np(jc).astype(np.int64))
    assert d.max() <= steps, d.max()
    assert (d == 0).mean() > 0.99


def _close_buffers(tcodes, tscales, jcodes, jscales, quantizes=True):
    assert set(tscales) == set(jscales)
    if quantizes:
        _close_codes(tcodes, jcodes)
    else:
        np.testing.assert_array_equal(_np(tcodes), _np(jcodes))
    for name in tscales:
        np.testing.assert_allclose(_np(tscales[name]), _np(jscales[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    k[0, 0, :3] = 0.0                               # all-zero rows: the eps
    k[1, 2, 5, :8] *= 40.0                          # channel outliers
    return k


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", BASELINES)
@pytest.mark.parametrize("bits", [4, 8])
def test_baseline_quantizers_match_jax(keys, method, bits):
    """Codes within one mid-tread step, scales/zeros/norms within 1e-6, and
    the generic encode_keys/decode_keys round trip through the container."""
    jcfg, tcfg = _qcfgs(method, key_bits=bits, group_size=G)
    jk = jq.encode_keys(jnp.asarray(keys), jcfg)
    tk = tq.encode_keys(torch.from_numpy(keys), tcfg)
    assert type(tk).__name__ == type(jk).__name__
    for f in dataclasses.fields(tk):
        if f.name == "bits":
            assert tk.bits == jk.bits == bits
        elif f.name == "codes":
            _close_codes(tk.codes, jk.codes)
        else:
            np.testing.assert_allclose(_np(getattr(tk, f.name)),
                                       _np(getattr(jk, f.name)), rtol=1e-6,
                                       atol=1e-6)
    # the same codes and stats decode to the same keys
    same = type(tk)(**{f.name: (torch.from_numpy(np.array(getattr(jk, f.name)))
                                if f.name != "bits" else bits)
                       for f in dataclasses.fields(tk)})
    np.testing.assert_allclose(tq.decode_keys(same).numpy(),
                               np.asarray(jq.decode_keys(jk)), rtol=1e-6,
                               atol=1e-6)
    assert tq.decode_keys(tk).shape == keys.shape


def test_polar_fixed_grid_matches_jax(keys):
    """theta_stats="fixed": codes exactly JAX's (4-ulp floor allowance),
    stats equal, theta_scale the float32 2pi/2^t and theta_zero 0;
    theta == 2pi exactly clips to the top code."""
    k = keys.copy()
    k[0, 1, 4, 0], k[0, 1, 4, 32] = -1.0, 0.0      # atan2(+0, -1) + pi = 2pi
    for bits in ((4, 4), (3, 5)):
        jcfg, tcfg = _qcfgs("polar", group_size=G, theta_stats="fixed",
                            rho_bits=bits[0], theta_bits=bits[1])
        jk = jq.encode_polar_keys(jnp.asarray(k), jcfg)
        tk = tq.encode_polar_keys(torch.from_numpy(k), tcfg)
        for name in ("rho_scale", "rho_zero", "theta_scale", "theta_zero"):
            np.testing.assert_allclose(_np(getattr(tk, name)),
                                       _np(getattr(jk, name)), rtol=1e-6,
                                       atol=1e-6)
        step = np.float32(2 * np.pi / (1 << bits[1]))
        assert (tk.theta_scale.numpy() == step).all()
        assert (tk.theta_zero.numpy() == 0).all()
        jc = np.asarray(jk.codes).astype(np.int32)
        tc = tk.codes.numpy().astype(np.int32)
        t_top = (1 << bits[1]) - 1
        assert tc[0, 1, 0, 4, 0] & t_top == t_top
        jr, jt = (np.asarray(x) for x in jpolar.to_polar(jnp.asarray(k)))
        jr, jt = (x.reshape(2, 3, -1, G, 32) for x in (jr, jt))
        for shift, nbits, v, s, z in (
                (bits[1], bits[0], jr, jk.rho_scale, jk.rho_zero),
                (0, bits[1], jt, jk.theta_scale, jk.theta_zero)):
            mask = (1 << nbits) - 1
            a, b = (jc >> shift) & mask, (tc >> shift) & mask
            moved = a != b
            if moved.any():
                assert np.abs(a - b)[moved].max() == 1
                assert _prefloor_ok(v, np.asarray(z), np.asarray(s))[
                    moved].all(), "a code flipped away from a boundary"


@pytest.mark.parametrize("theta_stats", ["group", "fixed"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("method", CODECS)
def test_bits_per_element_match_jax(method, head_dim, theta_stats):
    jcfg, tcfg = _qcfgs(method, group_size=128, key_bits=4,
                        theta_stats=theta_stats)
    assert tcfg.key_bits_per_element(head_dim) == \
        jcfg.key_bits_per_element(head_dim)
    assert tcfg.codec.quantizes == jcfg.codec.quantizes == (method != "none")


def test_bits_per_element_table():
    """The logical key bits of the chip run's arms at d 64, g 128."""
    expect = {("polar", "group", 4): 4.25, ("polar", "fixed", 4): 4.125,
              ("kivi", "group", 4): 4.25, ("int", "group", 4): 4.5,
              ("int", "group", 8): 8.5, ("zipcache", "group", 4): 4.625,
              ("none", "group", 4): 16.0}
    for (m, ts, b), bits in expect.items():
        cfg = tq.QuantConfig(method=m, theta_stats=ts, key_bits=b)
        assert cfg.key_bits_per_element(64) == bits, (m, ts, b)


@pytest.mark.parametrize("method", CODECS)
def test_init_buffers_and_scores_match_jax(keys, method):
    """init_buffers shapes and dtypes equal JAX's; scores equal
    dequantize-then-matmul (the LUT for polar: within 1e-4)."""
    jcfg, tcfg = _qcfgs(method, group_size=G, key_bits=4)
    jc, js = jcfg.codec.init_buffers(jcfg, (2, 3), 64, 64, jnp.float32)
    tc, ts = tcfg.codec.init_buffers(tcfg, (2, 3), 64, 64, torch.float32,
                                     "cpu")
    assert tuple(tc.shape) == jc.shape and set(ts) == set(js)
    assert all(tuple(ts[n].shape) == js[n].shape for n in ts)
    assert str(tc.dtype).split(".")[1] == str(jc.dtype)
    codec = tcfg.codec
    codes, scales = codec.encode(tcfg, torch.from_numpy(keys))
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 4, 64)).astype(np.float32))
    got = codec.scores(tcfg, q, codes, scales)
    ref = torch.einsum("bhqd,bhtd->bhqt", q,
                       codec.decode(tcfg, codes, scales))
    tol = 1e-4 if method == "polar" else 1e-6
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol, atol=tol)
    assert codec.container(tcfg, codes, scales) is not None
    assert tcodecs.registered_codecs()[method] is codec


def test_registry_refuses_duplicates_and_overwrites():
    codec = tcodecs.get_codec("int")
    with pytest.raises(ValueError, match="already registered"):
        tcodecs.register_codec(codec)
    assert tcodecs.register_codec(codec, overwrite=True) is codec
    with pytest.raises(KeyError, match="unknown key codec"):
        tcodecs.get_codec("nope")


# ---------------------------------------------------------------------------
# dense and paged caches
# ---------------------------------------------------------------------------

LAYOUT = dict(page_size=G, num_pages=20, slots=4, pages_per_slot=8)
PROMPT, STEPS, SLOT, BUCKET = 38, 13, 2, 48


def _fill(method, value_bits=0):
    """One token stream (a 38-token prompt, 13 appends crossing a page
    boundary) into a dense cache and a paged slot of both packages.
    Returns {"j": (dense, paged, table), "t": (...)}."""
    rng = np.random.default_rng(3)
    t = PROMPT + STEPS
    k = rng.standard_normal((1, H, t, D)).astype(np.float32)
    v = rng.standard_normal((1, H, t, D)).astype(np.float32)
    jcfg, tcfg = _qcfgs(method, group_size=G, key_bits=4,
                        value_bits=value_bits)
    cap = LAYOUT["pages_per_slot"] * G
    alloc = JAlloc(JLayout(**LAYOUT))
    assert alloc.alloc(SLOT, 3)
    pad = np.zeros((1, H, BUCKET, D), np.float32)
    kp, vp = pad.copy(), pad.copy()
    kp[:, :, :PROMPT], vp[:, :, :PROMPT] = k[:, :, :PROMPT], v[:, :, :PROMPT]
    s = LAYOUT["slots"]

    jd = jkv.prefill(jkv.init_cache(jcfg, 1, H, D, cap, jnp.float32,
                                    layout=JLinear(cap)),
                     jnp.asarray(k[:, :, :PROMPT]), jnp.asarray(v[:, :, :PROMPT]))
    td = tkv.prefill(tkv.init_cache(tcfg, 1, H, D, cap, torch.float32,
                                    device="cpu"),
                     torch.from_numpy(k[:, :, :PROMPT]),
                     torch.from_numpy(v[:, :, :PROMPT]))
    jp = jpg.paged_prefill(jpg.init_paged_cache(jcfg, JLayout(**LAYOUT), H, D,
                                                dtype=jnp.float32),
                           jnp.asarray(SLOT), jnp.asarray(alloc.table_np()[SLOT]),
                           jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(PROMPT))
    tp = tpg.paged_prefill(tpg.init_paged_cache(tcfg, PagedLayout(**LAYOUT), H,
                                                D, dtype=torch.float32,
                                                device="cpu"),
                           SLOT, torch.from_numpy(alloc.table_np()[SLOT]),
                           torch.from_numpy(kp), torch.from_numpy(vp), PROMPT)
    for i in range(PROMPT, t):
        if i % G == 0 and alloc.slot_pages(SLOT) <= i // G:
            assert alloc.alloc(SLOT, 1)
        kn = np.zeros((s, H, 1, D), np.float32)
        vn = np.zeros((s, H, 1, D), np.float32)
        kn[SLOT], vn[SLOT] = k[0, :, i:i + 1], v[0, :, i:i + 1]
        act = np.zeros((s,), bool)
        act[SLOT] = True
        tab = alloc.table_np()
        jd = _j_append(jd, jnp.asarray(k[:, :, i:i + 1]),
                       jnp.asarray(v[:, :, i:i + 1]))
        tkv.append(td, torch.from_numpy(k[:, :, i:i + 1]),
                   torch.from_numpy(v[:, :, i:i + 1]))
        jp = _j_paged_append(jp, jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(tab), jnp.asarray(act))
        tpg.paged_append(tp, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(tab), torch.from_numpy(act))
    tab = alloc.table_np()
    return {"j": (jd, jp, tab), "t": (td, tp, tab)}


@pytest.fixture(scope="module", params=["int", "kivi", "zipcache", "none"])
def filled(request):
    return request.param, _fill(request.param)


def test_caches_match_jax(filled):
    """Dense and paged buffers of the port equal JAX's (pools outside the
    never-read scratch page)."""
    method, c = filled
    jd, jp, _ = c["j"]
    td, tp, _ = c["t"]
    quant = method != "none"
    _close_buffers(td.key_codes, td.key_scales, jd.key_codes, jd.key_scales,
                   quant)
    keep = slice(0, LAYOUT["num_pages"])
    _close_buffers(tp.key_codes[keep], {n: x[keep] for n, x in
                                        tp.key_scales.items()},
                   np.asarray(jp.key_codes)[keep],
                   {n: np.asarray(x)[keep] for n, x in jp.key_scales.items()},
                   quant)
    np.testing.assert_array_equal(tp.value_fp.numpy()[keep],
                                  np.asarray(jp.value_fp)[keep])
    np.testing.assert_array_equal(tp.lengths.numpy(), np.asarray(jp.lengths))
    assert int(td.length) == int(jd.length) == PROMPT + STEPS
    grouped = tcodecs.get_codec(method).grouped
    assert (tp.key_residual is None) == (jp.key_residual is None) == \
        (not grouped)
    if grouped:
        np.testing.assert_array_equal(_np(tp.key_residual),
                                      _np(jp.key_residual))


def test_paged_decode_matches_dense_and_jax(filled):
    """Decode attention: paged (every backend; a codec without a
    page-native kernel takes the gathered route on "paged_fused") equals
    the dense cache's, and JAX's, within 1e-4; the gathered view's codes
    equal the dense codes."""
    method, c = filled
    jd, jp, tab = c["j"]
    td, tp, _ = c["t"]
    q = np.random.default_rng(9).standard_normal((1, 2 * H, D)).astype(
        np.float32)
    qs = np.zeros((LAYOUT["slots"], 2 * H, D), np.float32)
    qs[SLOT] = q[0]
    o_dense = tkv.decode_attention(td, torch.from_numpy(q))[0].numpy()
    np.testing.assert_allclose(
        o_dense, np.asarray(jkv.decode_attention(jd, jnp.asarray(q)))[0],
        rtol=1e-4, atol=1e-4)
    view = tpg.gather_view(tp, torch.from_numpy(tab))
    n = (PROMPT + STEPS) if not tcodecs.get_codec(method).grouped else \
        (PROMPT + STEPS) // G
    np.testing.assert_array_equal(_np(view.key_codes[SLOT, :, :n]),
                                  _np(td.key_codes[0, :, :n]))
    jo = jpg.paged_decode_attention(jp, jnp.asarray(qs), jnp.asarray(tab),
                                    backend="paged_fused")
    for backend in tpg.DECODE_BACKENDS:
        o = tpg.paged_decode_attention(tp, torch.from_numpy(qs),
                                       torch.from_numpy(tab),
                                       backend=backend)[SLOT].numpy()
        np.testing.assert_allclose(o, o_dense, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o, np.asarray(jo)[SLOT], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("method", ["int", "none", "polar"])
def test_chunk_prefill_attention_matches_jax(method):
    """The gathered chunk attention (the "jnp" route, and a codec without
    a page-native prefill on "paged_fused") against JAX's at 1e-4: a
    32-token prefix in two pages, then a 16-token chunk at start 32 of
    which 11 tokens are real; full and width-sliced rows."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = _qcfgs(method, group_size=G, key_bits=8, value_bits=4)
    alloc = JAlloc(JLayout(**LAYOUT))
    assert alloc.alloc(1, 3)
    row = alloc.table_np()[1]
    k = rng.standard_normal((1, H, 32, D)).astype(np.float32)
    v = rng.standard_normal((1, H, 32, D)).astype(np.float32)
    jc = jpg.paged_prefill(jpg.init_paged_cache(jcfg, JLayout(**LAYOUT), H, D,
                                                dtype=jnp.float32),
                           jnp.asarray(1), jnp.asarray(row), jnp.asarray(k),
                           jnp.asarray(v), jnp.asarray(32))
    tc = tpg.paged_prefill(tpg.init_paged_cache(tcfg, PagedLayout(**LAYOUT), H,
                                                D, dtype=torch.float32,
                                                device="cpu"),
                           1, torch.from_numpy(row), torch.from_numpy(k),
                           torch.from_numpy(v), 32)
    q = rng.standard_normal((1, 2 * H, G, D)).astype(np.float32)
    kc = rng.standard_normal((1, H, G, D)).astype(np.float32)
    vc = rng.standard_normal((1, H, G, D)).astype(np.float32)
    args = (q, kc, vc)
    jo = jpg.chunk_prefill_attention(jc, *map(jnp.asarray, args),
                                     jnp.asarray(row), 32, 11)
    for r in (row, row[:3]):
        to = tpg.chunk_prefill_attention(tc, *map(torch.from_numpy, args),
                                         torch.from_numpy(r.copy()), 32, 11)
        np.testing.assert_allclose(to.numpy()[:, :, :11],
                                   np.asarray(jo)[:, :, :11], rtol=1e-4,
                                   atol=1e-4)
        for backend in tpg.PREFILL_BACKENDS:
            bo = tpg.paged_prefill_attention(
                tc, *map(torch.from_numpy, args), torch.from_numpy(r.copy()),
                32, 11, backend=backend)
            np.testing.assert_allclose(bo.numpy()[:, :, :11],
                                       to.numpy()[:, :, :11], rtol=1e-4,
                                       atol=1e-4)


def test_cow_split_bit_identical_decode_int():
    """Port of ``tests/test_prefix_cache.py::test_cow_split_bit_identical_
    decode[int]``: a sharer whose table aliases the donor's pages and
    whose length ends mid-page appends through a COW split; the donor's
    view never changes and the sharer decodes bit for bit like an
    unshared replica."""
    g, h, d = 4, 2, 8
    cfg = tq.QuantConfig(method="int", group_size=g, key_bits=4,
                         value_bits=4)
    lay = PagedLayout(page_size=g, num_pages=8, slots=3, pages_per_slot=2)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.standard_normal((1, h, 2 * g, d)).astype(
        np.float32))
    vals = torch.from_numpy(rng.standard_normal((1, h, 2 * g, d)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 2, d)).astype(np.float32))
    k_new = torch.from_numpy(rng.standard_normal((3, h, 1, d)).astype(
        np.float32))
    v_new = torch.from_numpy(rng.standard_normal((3, h, 1, d)).astype(
        np.float32))
    tl = g + g // 2

    def build(shared):
        alloc = PageAllocator(lay)
        cache = tpg.init_paged_cache(cfg, lay, h, d, dtype=torch.float32,
                                     device="cpu")
        alloc.alloc(0, 2)
        tpg.paged_prefill(cache, 0, alloc.table()[0], toks, vals, 2 * g)
        alloc.alloc(1, 2)
        tpg.paged_prefill(cache, 1, alloc.table()[1], toks, vals, tl)
        if shared:
            alloc.free_slot(1)
            alloc.adopt(1, alloc.slot_page_ids(0))
        return alloc, cache

    def decode(cache, alloc, slot):
        view = tpg.gather_view(cache, alloc.table())
        return tkv.decode_attention(view, q.repeat(3, 1, 1))[slot]

    def value_rows(cache, alloc):
        return tpg.gather_view(cache, alloc.table()[:1]).value_codes.clone()

    (alloc_s, cache_s), (alloc_u, cache_u) = build(True), build(False)
    assert torch.equal(decode(cache_s, alloc_s, 1), decode(cache_u, alloc_u, 1))
    donor = value_rows(cache_s, alloc_s)
    for alloc, cache in ((alloc_s, cache_s), (alloc_u, cache_u)):
        split = alloc.cow(1, tl // g)
        if split is not None:
            tpg.copy_pool_pages(cache, *split)
        active = torch.tensor([False, True, False])
        tpg.paged_append(cache, k_new, v_new, alloc.table(), active)
    assert torch.equal(decode(cache_s, alloc_s, 1), decode(cache_u, alloc_u, 1))
    assert torch.equal(value_rows(cache_s, alloc_s), donor)


@pytest.mark.parametrize("method", ["int", "none", "kivi"])
def test_span_verify_and_commit_match_jax(method):
    """``span_verify_attention`` and ``paged_append_span`` on a token-wise
    and a grouped baseline against JAX's (1e-4; buffers as above)."""
    rng = np.random.default_rng(11)
    jcfg, tcfg = _qcfgs(method, group_size=G, key_bits=8)
    lay = dict(page_size=G, num_pages=12, slots=2, pages_per_slot=4)
    alloc = JAlloc(JLayout(**lay))
    caches = {"j": jpg.init_paged_cache(jcfg, JLayout(**lay), H, D,
                                        dtype=jnp.float32),
              "t": tpg.init_paged_cache(tcfg, PagedLayout(**lay), H, D,
                                        dtype=torch.float32, device="cpu")}
    for slot, tl in enumerate((21, 40)):
        assert alloc.alloc(slot, 3)
        k = rng.standard_normal((1, H, 48, D)).astype(np.float32)
        v = rng.standard_normal((1, H, 48, D)).astype(np.float32)
        row = alloc.table_np()[slot]
        caches["j"] = jpg.paged_prefill(
            caches["j"], jnp.asarray(slot), jnp.asarray(row), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(tl))
        tpg.paged_prefill(caches["t"], slot, torch.from_numpy(row),
                          torch.from_numpy(k), torch.from_numpy(v), tl)
    tab = alloc.table_np()
    qn = 4
    q = rng.standard_normal((2, 2 * H, qn, D)).astype(np.float32)
    ks = rng.standard_normal((2, H, qn, D)).astype(np.float32)
    vs = rng.standard_normal((2, H, qn, D)).astype(np.float32)
    jo = _j_span_verify(caches["j"], jnp.asarray(q), jnp.asarray(ks),
                        jnp.asarray(vs), jnp.asarray(tab))
    to = tpg.span_verify_attention(caches["t"], torch.from_numpy(q),
                                   torch.from_numpy(ks), torch.from_numpy(vs),
                                   torch.from_numpy(tab))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    n_keep = np.array([3, 4], np.int32)       # slot 1 fills its group
    jc = jpg.paged_append_span(caches["j"], jnp.asarray(ks), jnp.asarray(vs),
                               jnp.asarray(tab), jnp.asarray(n_keep))
    tc = tpg.paged_append_span(caches["t"], torch.from_numpy(ks),
                               torch.from_numpy(vs), torch.from_numpy(tab),
                               torch.from_numpy(n_keep))
    keep = slice(0, lay["num_pages"])
    _close_buffers(tc.key_codes[keep], {n: x[keep] for n, x in
                                        tc.key_scales.items()},
                   np.asarray(jc.key_codes)[keep],
                   {n: np.asarray(x)[keep] for n, x in jc.key_scales.items()},
                   method != "none")
    np.testing.assert_array_equal(tc.value_fp.numpy()[keep],
                                  np.asarray(jc.value_fp)[keep])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


# ---------------------------------------------------------------------------
# SnapKV eviction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [16, 48, 200])
def test_snapkv_select_matches_jax(budget):
    rng = np.random.default_rng(budget)
    k = rng.standard_normal((2, 2, 128, 16)).astype(np.float32)
    q = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tev.snapkv_scores(torch.from_numpy(q), torch.from_numpy(k)).numpy(),
        np.asarray(jev.snapkv_scores(jnp.asarray(q), jnp.asarray(k))),
        rtol=1e-5, atol=1e-6)
    tm = tev.snapkv_select(torch.from_numpy(q), torch.from_numpy(k), budget,
                           16).numpy()
    jm = np.asarray(jev.snapkv_select(jnp.asarray(q), jnp.asarray(k), budget,
                                      16))
    np.testing.assert_array_equal(tm, jm)
    assert tm[:, :, -16:].all() and tm.sum(-1).max() == min(budget, 128)


# ---------------------------------------------------------------------------
# the dispatch guard
# ---------------------------------------------------------------------------

_DISPATCH = re.compile(r"\.method\s*(==|!=|\bin\b|\bnot\s+in\b)")


def test_no_method_string_dispatch_outside_codecs():
    """No ``x.method ==`` / ``!=`` / ``in`` dispatch in ``src/repro_torch``
    outside ``core/codecs.py``: the caches and engines branch on codec
    capabilities."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    allowed = root / "core" / "codecs.py"
    hits = []
    for path in sorted(root.rglob("*.py")):
        if path == allowed:
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if _DISPATCH.search(code):
                hits.append(f"{path.relative_to(root)}:{n}: {line.strip()}")
    assert not hits, "string dispatch on .method:\n" + "\n".join(hits)
    # the pattern catches what it is meant to
    for bad in ('if cfg.method == "int":', "x.method != 'polar'",
                'if q.method in ("int", "none"):'):
        assert _DISPATCH.search(bad), bad
    assert not _DISPATCH.search("cfg.method_name = 1")
