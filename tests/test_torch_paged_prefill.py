"""Port parity: page-native chunk-prefill attention (the plain version of
the paged-prefill kernel, and ``paged_prefill_attention`` on CPU tensors)
against the JAX package's oracle ``ref_polar_paged_prefill_attention``,
its Pallas kernel in interpret mode, and JAX's gathering
``chunk_prefill_attention``.

The page pools are built once as numpy bytes (codes uint8, stats fp32,
values fp32) and the same bytes go to both sides, so the comparison does
not depend on the float32 atan2/sqrt ulps of the two libraries' encoders
(ROADMAP queue 3). Tolerance: rtol = atol = 1e-4 in fp32, as the JAX
kernel tests. The rem == 0 residual-poison invariant of
``tests/test_paged_prefill.py`` is ported with fp values."""
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
from repro.core import paged_cache as jpg  # noqa: E402
from repro.core.cache_layout import PagedLayout as JLayout  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_prefill as tpp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

H, D, G = 2, 32, 16
P = D // 2
QPK = 2                      # GQA: query heads per kv head
TC = 16                      # chunk bucket (tokens)
NUM_PAGES, SLOTS, N = 24, 3, 6
SCRATCH = NUM_PAGES
# fragmented, non-monotonic row: the walk must follow logical order
ROW = np.array([9, 0, 5, 1, 2, 3], np.int32)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    pp = NUM_PAGES + 1
    codes = rng.integers(0, 256, (pp, H, G, P)).astype(np.uint8)

    def stat(lo, hi):
        return (lo + (hi - lo) * rng.random((pp, H, 1, P))).astype(np.float32)

    stats = (stat(0.01, 0.3), stat(0.0, 1.0), stat(0.05, 0.4), stat(0.0, 0.5))
    values = rng.standard_normal((pp, H, G, D)).astype(np.float32)
    return codes, stats, values


def _chunk(seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H * QPK, TC, D)).astype(np.float32)
    k = rng.standard_normal((1, H, TC, D)).astype(np.float32)
    v = rng.standard_normal((1, H, TC, D)).astype(np.float32)
    return q, k, v


def _caches(codes, stats, values):
    names = ("rho_scale", "rho_zero", "theta_scale", "theta_zero")
    jc = jpg.init_paged_cache(
        JQuantConfig(group_size=G), JLayout(page_size=G, num_pages=NUM_PAGES,
                                            slots=SLOTS, pages_per_slot=N),
        H, D, dtype=jnp.float32)
    jc = dataclasses.replace(
        jc, key_codes=jnp.asarray(codes), value_fp=jnp.asarray(values),
        key_scales={n: jnp.asarray(s) for n, s in zip(names, stats)})
    tc = tpg.init_paged_cache(
        QuantConfig(group_size=G), PagedLayout(page_size=G,
                                               num_pages=NUM_PAGES,
                                               slots=SLOTS, pages_per_slot=N),
        H, D, dtype=torch.float32, device="cpu")
    tc.key_codes = torch.from_numpy(codes.copy())
    tc.value_fp = torch.from_numpy(values.copy())
    tc.key_scales = {n: torch.from_numpy(s.copy())
                     for n, s in zip(names, stats)}
    return jc, tc


def _jax_ref(q, k, v, codes, stats, values, row, start, clen):
    return np.asarray(jref.ref_polar_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(codes),
        *(jnp.asarray(s) for s in stats), jnp.asarray(values), None, None,
        jnp.asarray(row), jnp.asarray(start, jnp.int32),
        jnp.asarray(clen, jnp.int32), r_bits=4, t_bits=4))


def _port_ref(q, k, v, codes, stats, values, row, start, clen):
    t = torch.from_numpy
    return tref.ref_polar_paged_prefill_attention(
        t(q), t(k), t(v), t(codes), *(t(s) for s in stats), t(values),
        t(row.copy()), start, clen, r_bits=4, t_bits=4).numpy()


# (start, chunk_len, row width): the first chunk (no page read), a
# fragmented prefix, a ragged chunk, and a width-sliced row
CASES = [(0, TC, N), (3 * G, TC, N), (3 * G, 13, N), (3 * G, 13, 4),
         (5 * G, 5, N)]


@pytest.mark.parametrize("start,clen,width", CASES)
def test_plain_version_matches_jax_oracle(start, clen, width):
    codes, stats, values = _pools()
    q, k, v = _chunk()
    row = ROW[:width]
    want = _jax_ref(q, k, v, codes, stats, values, row, start, clen)
    got = _port_ref(q, k, v, codes, stats, values, row, start, clen)
    np.testing.assert_allclose(got, want, **TOL)
    # the route the engine takes on CPU tensors: fold + pre-scale, the
    # kernel wrapper's plain version, unfold
    jc, tc = _caches(codes, stats, values)
    t = torch.from_numpy
    via_cache = tpg.paged_prefill_attention(tc, t(q), t(k), t(v),
                                            t(row.copy()), start, clen)
    np.testing.assert_allclose(via_cache.numpy(), want, **TOL)
    # JAX's gathering formulation: a second, independent reference
    jchunk = np.asarray(jpg.chunk_prefill_attention(
        jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(row),
        jnp.asarray(start, jnp.int32), jnp.asarray(clen, jnp.int32)))
    np.testing.assert_allclose(got, jchunk, **TOL)
    np.testing.assert_allclose(via_cache.numpy(), jchunk, **TOL)


def test_plain_version_matches_jax_pallas_interpret():
    """The JAX Pallas kernel itself (interpret mode) on a fragmented
    prefix with a ragged chunk."""
    codes, stats, values = _pools(1)
    q, k, v = _chunk(8)
    start, clen = 4 * G, 11
    want = np.asarray(jops.polar_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(codes),
        *(jnp.asarray(s) for s in stats), jnp.asarray(values), None, None,
        jnp.asarray(ROW), jnp.asarray(start, jnp.int32),
        jnp.asarray(clen, jnp.int32), backend="interpret"))
    got = _port_ref(q, k, v, codes, stats, values, ROW, start, clen)
    np.testing.assert_allclose(got, want, **TOL)


def test_width_sliced_row_equals_full_row():
    codes, stats, values = _pools(2)
    q, k, v = _chunk(9)
    start, clen = 2 * G, 9
    full = _port_ref(q, k, v, codes, stats, values, ROW, start, clen)
    sliced = _port_ref(q, k, v, codes, stats, values, ROW[:3], start, clen)
    np.testing.assert_allclose(sliced, full, **TOL)


def test_poisoned_scratch_page_and_dead_rows_never_leak():
    """NaN on the scratch page (behind every dead table entry), NaN value
    rows of live pages at or past ``start``, and NaN chunk K/V rows past
    ``chunk_len``: the plain version gives the clean JAX result."""
    codes, stats, values = _pools(3)
    q, k, v = _chunk(10)
    start, clen = 3 * G, 10
    row = ROW.copy()
    row[4:] = SCRATCH
    want = _jax_ref(q, k, v, codes, stats, values, row, start, clen)
    stats = tuple(s.copy() for s in stats)
    values = values.copy()
    for s in stats:
        s[SCRATCH] = np.nan
    values[SCRATCH] = np.nan
    values[ROW[3]] = np.nan          # page 3 starts at `start`: all dead
    k, v = k.copy(), v.copy()
    k[:, :, clen:] = np.nan
    v[:, :, clen:] = np.nan
    got = _port_ref(q, k, v, codes, stats, values, row, start, clen)
    assert np.isfinite(got[:, :, :clen]).all()
    np.testing.assert_allclose(got[:, :, :clen], want[:, :, :clen], **TOL)
    # the rows past chunk_len are padding: finite is all that is asked
    assert np.isfinite(got).all()


def test_misaligned_start_raises():
    codes, stats, values = _pools()
    t = torch.from_numpy
    qf = torch.zeros((H, QPK * TC, D))
    kc = torch.zeros((H, TC, D))
    with pytest.raises(ValueError, match="page-aligned"):
        tpp.polar_paged_prefill_grouped(
            qf, kc, kc, t(codes), *(t(s) for s in stats), t(values),
            t(ROW.copy()), 5, TC)
    with pytest.raises(ValueError, match="beyond the table row"):
        tpp.polar_paged_prefill_grouped(
            qf, kc, kc, t(codes), *(t(s) for s in stats), t(values),
            t(ROW[:2].copy()), 3 * G, TC)


def test_ops_entry_folds_rows_like_jax():
    """``ops.polar_paged_prefill_attention`` (fold, pre-scale, wrapper,
    unfold) against the JAX ops entry at ``backend="ref"``."""
    codes, stats, values = _pools(4)
    q, k, v = _chunk(11)
    start, clen = 2 * G, TC
    want = np.asarray(jops.polar_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(codes),
        *(jnp.asarray(s) for s in stats), jnp.asarray(values), None, None,
        jnp.asarray(ROW), jnp.asarray(start, jnp.int32),
        jnp.asarray(clen, jnp.int32), backend="ref", softmax_scale=0.3))
    t = torch.from_numpy
    got = tops.polar_paged_prefill_attention(
        t(q), t(k), t(v), t(codes), *(t(s) for s in stats), t(values),
        t(ROW.copy()), start, clen, softmax_scale=0.3)
    assert got.shape == (1, H * QPK, TC, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# rem == 0: the misaligned-residual invariant at exact page multiples
# ---------------------------------------------------------------------------


def test_rem_zero_residual_garbage_never_visible():
    """Port of ``tests/test_paged_prefill.py:185`` with fp values: when a
    prefill chunk ends exactly on a page boundary, ``paged_prefill``
    writes a misaligned window into ``key_residual``. That garbage is
    dead: poisoning the residual after each such chunk must not change a
    single output bit across a chunked prefill -> append -> decode
    sequence; the clean arm also matches JAX."""
    rng = np.random.default_rng(3)
    chunks = [(rng.standard_normal((1, H, G, D)).astype(np.float32),
               rng.standard_normal((1, H, G, D)).astype(np.float32))
              for _ in range(2)]
    q = rng.standard_normal((1, H * QPK, G, D)).astype(np.float32)
    k1 = rng.standard_normal((SLOTS, H, 1, D)).astype(np.float32)
    v1 = rng.standard_normal((SLOTS, H, 1, D)).astype(np.float32)
    qd = rng.standard_normal((SLOTS, H * QPK, D)).astype(np.float32)
    table = np.tile(ROW[None], (SLOTS, 1))
    active = np.array([True, False, False])
    t = torch.from_numpy

    outs = []
    for arm in ("clean", "poisoned"):
        cache = tpg.init_paged_cache(
            QuantConfig(group_size=G, residual_dtype="float32"),
            PagedLayout(page_size=G, num_pages=NUM_PAGES, slots=SLOTS,
                        pages_per_slot=N), H, D, dtype=torch.float32,
            device="cpu")
        arm_out = []
        for i, (k, v) in enumerate(chunks):       # two chunks of exactly g
            arm_out.append(tpg.paged_prefill_attention(
                cache, t(q), t(k), t(v), t(ROW.copy()), i * G, G))
            tpg.paged_prefill(cache, 0, t(ROW.copy()), t(k), t(v), G,
                              start=i * G)
            if arm == "poisoned":
                cache.key_residual.fill_(1e9)     # rem == 0: garbage anyway
        tpg.paged_append(cache, t(k1), t(v1), t(table), t(active))
        arm_out.append(tpg.paged_decode_attention(cache, t(qd), t(table)))
        outs.append([o.numpy() for o in arm_out])
    for o_clean, o_poisoned in zip(*outs):
        np.testing.assert_array_equal(o_clean, o_poisoned)

    jc = jpg.init_paged_cache(
        JQuantConfig(group_size=G, residual_dtype="float32"),
        JLayout(page_size=G, num_pages=NUM_PAGES, slots=SLOTS,
                pages_per_slot=N), H, D, dtype=jnp.float32)
    jouts = []
    row = jnp.asarray(ROW)
    for i, (k, v) in enumerate(chunks):
        start = jnp.asarray(i * G, jnp.int32)
        jouts.append(jpg.paged_prefill_attention(
            jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), row, start,
            jnp.asarray(G, jnp.int32), backend="paged_fused"))
        jc = jpg.paged_prefill(jc, jnp.asarray(0), row, jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(G), start=start)
    jc = jpg.paged_append(jc, jnp.asarray(k1), jnp.asarray(v1),
                          jnp.asarray(table), jnp.asarray(active))
    jouts.append(jpg.paged_decode_attention(
        jc, jnp.asarray(qd), jnp.asarray(table), backend="paged_fused"))
    for got, want in zip(outs[0], jouts):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
