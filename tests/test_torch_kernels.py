"""Port parity: the plain versions behind the three kernel wrappers of
``repro_torch.kernels`` (what a CPU tensor runs) against the JAX package's
``ops`` on the ``"ref"`` backend, and once per kernel against the Pallas
kernel body in interpret mode. Inputs come from numpy.

Tolerances as the JAX suite (``tests/test_kernels.py``): polar codes
exactly equal, attention outputs rtol = atol = 1e-4 in fp32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.attention import flash_attention, reference_attention  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as j_flash_pallas  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import polar_encode as pek  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# the JAX references, jitted once per shape (eager dispatch of their many
# small ops costs more CPU than the comparisons themselves)
_j_encode = jax.jit(jops.polar_encode,
                    static_argnames=("group_size", "backend"))
_j_grouped = jax.jit(jops.polar_paged_decode_attention_grouped,
                     static_argnames=("backend",))
_j_full = jax.jit(jops.polar_paged_decode_attention_full,
                  static_argnames=("backend",))
_j_ref_attn = jax.jit(reference_attention)
_j_flash = jax.jit(flash_attention, static_argnames=("chunk",))


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# polar encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,g", [(32, 16), (64, 32)])
def test_encode_plain_matches_jax_ref(d, g):
    k = np.random.default_rng(0).standard_normal((2, 2, 3 * g, d)).astype(
        np.float32)
    jout = _j_encode(j(k), group_size=g, backend="ref")
    tout = ops.polar_encode(t(k), group_size=g)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_encode_plain_matches_pallas_interpret():
    k = np.random.default_rng(1).standard_normal((1, 2, 32, 32)).astype(
        np.float32)
    jout = jops.polar_encode(j(k), group_size=16, backend="interpret")
    tout = ops.polar_encode(t(k), group_size=16)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))


def test_encode_pages_writes_only_named_pages():
    """Paged form: group (b, n) -> pool page pages[b, n]; -1 skips. Equal to
    the dense encode scattered by hand."""
    g, d, h, pp = 16, 32, 2, 9
    k = np.random.default_rng(2).standard_normal((2, h, 2 * g, d)).astype(
        np.float32)
    pages = torch.tensor([[4, -1], [0, 7]], dtype=torch.int32)
    pools = [torch.zeros((pp, h, g, d // 2), dtype=torch.uint8)] + \
        [torch.zeros((pp, h, 1, d // 2)) for _ in range(4)]
    ops.polar_encode_pages(t(k), pages, *pools)
    dense = ops.polar_encode(t(k), group_size=g)
    for pool, x in zip(pools, dense):
        for (b, n), page in {(0, 0): 4, (1, 0): 0, (1, 1): 7}.items():
            assert torch.equal(pool[page], x[b, :, n])
        for page in (1, 2, 3, 5, 6, 8):
            assert not pool[page].any()


# ---------------------------------------------------------------------------
# page-native decode
# ---------------------------------------------------------------------------

HKV, QH, D, G, PP = 2, 4, 32, 16, 20
SCRATCH = PP - 1


def _decode_inputs(seed=0, s=4, n=4):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((PP, HKV, G, D)).astype(np.float32)
    enc = _j_encode(j(k.reshape(1, PP * HKV, G, D)), group_size=G,
                    backend="ref")
    pool = [np.asarray(x).reshape(PP, HKV, *x.shape[-2:]) for x in enc]
    values = rng.standard_normal((PP, HKV, G, D)).astype(np.float32)
    q = (rng.standard_normal((s, HKV, QH, D)) * D ** -0.5).astype(np.float32)
    # fragmented, non-monotonic rows; unassigned entries -> scratch
    table = np.full((s, n), SCRATCH, np.int32)
    perm = rng.permutation(SCRATCH)
    flushed = np.array([0, 16, 48, 64][:s], np.int32)
    off = 0
    for sl in range(s):
        live = flushed[sl] // G
        table[sl, :live] = perm[off:off + live]
        off += live
    return q, pool, values, table, flushed


def _poison(pool, values):
    pool = [x.copy() for x in pool]
    for x in pool[1:]:
        x[SCRATCH] = np.nan
    values = values.copy()
    values[SCRATCH] = np.nan
    return pool, values


def _decode_both(q, pool, values, table, flushed, backend="ref"):
    jout = _j_grouped(j(q), *(j(x) for x in pool), j(values), None, None,
                      j(table), j(flushed), backend=backend)
    tout = ops.polar_paged_decode_attention_grouped(
        t(q), *(t(x) for x in pool), t(values), t(table), t(flushed))
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


@pytest.mark.parametrize("poisoned", [False, True])
def test_paged_decode_plain_matches_jax_ref(poisoned):
    """Fragmented table, a flushed == 0 slot, and (poisoned) NaN stats and
    value rows on the scratch page: nothing may leak."""
    q, pool, values, table, flushed = _decode_inputs()
    if poisoned:
        pool, values = _poison(pool, values)
    jout, tout = _decode_both(q, pool, values, table, flushed)
    for a, b in zip(tout, jout):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **TOL)
    assert tout[2][0].max() == 0.0          # flushed == 0: empty partials


def test_paged_decode_width_sliced_table():
    q, pool, values, table, flushed = _decode_inputs(seed=1)
    wide = np.concatenate([table, np.full_like(table, SCRATCH)], axis=1)
    _, full = _decode_both(q, pool, values, wide, flushed)
    _, sliced = _decode_both(q, pool, values, table, flushed)
    for a, b in zip(full, sliced):
        np.testing.assert_allclose(a, b, **TOL)
    # a non-contiguous width slice of the wide table reads the same pages
    tout = ops.polar_paged_decode_attention_grouped(
        t(q), *(t(x) for x in pool), t(values),
        t(wide)[:, :table.shape[1]], t(flushed))
    for a, b in zip(tout, sliced):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_paged_decode_plain_matches_pallas_interpret():
    q, pool, values, table, flushed = _decode_inputs(seed=2, s=3, n=3)
    pool, values = _poison(pool, values)
    jout, tout = _decode_both(q, pool, values, table, flushed[:3] // G * G,
                              backend="interpret")
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, **TOL)


def test_paged_decode_full_matches_jax():
    """End to end with the fp residual merge: per-slot lengths with
    rem == 0, rem > 0 and empty slots; bf16 residual keys."""
    q, pool, values, table, flushed = _decode_inputs(seed=3, n=5)
    rng = np.random.default_rng(4)
    s = table.shape[0]
    lengths = flushed + np.array([5, 0, 15, 1], np.int32)
    # the page being filled holds the residual's value rows
    for sl in range(s):
        if lengths[sl] > flushed[sl]:
            table[sl, flushed[sl] // G] = SCRATCH - 1 - sl
    res = rng.standard_normal((s, HKV, G, D)).astype(np.float32)
    res_bf = jnp.asarray(res).astype(jnp.bfloat16)
    qf = rng.standard_normal((s, HKV * QH, D)).astype(np.float32)
    jo = _j_full(j(qf), *(j(x) for x in pool), res_bf, j(values), None,
                 None, j(table), j(lengths), backend="ref")
    to = ops.polar_paged_decode_attention_full(
        t(qf), *(t(x) for x in pool), t(res).to(torch.bfloat16), t(values),
        t(table), t(lengths))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_merge_softmax_partials_matches_jax():
    rng = np.random.default_rng(5)
    parts = []
    for m_fill in (0.3, -1e30):
        acc = rng.standard_normal((3, 4, 8)).astype(np.float32)
        m = np.full((3, 4), m_fill, np.float32)
        lv = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
        parts.append((acc, m, lv if m_fill > -1 else np.zeros_like(lv)))
    jo = jops.merge_softmax_partials([tuple(j(x) for x in p) for p in parts])
    to = ops.merge_softmax_partials([tuple(t(x) for x in p) for p in parts])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tq,hkv", [(40, 2), (64, 4), (7, 1)])
def test_flash_prefill_plain_matches_jax(tq, hkv):
    """Causal GQA; Tq not a multiple of any tile. The JAX serving path runs
    ``flash_attention`` here; its oracle is ``reference_attention``."""
    rng = np.random.default_rng(tq)
    q = rng.standard_normal((1, 4, tq, 32)).astype(np.float32)
    k = rng.standard_normal((1, hkv, tq, 32)).astype(np.float32)
    v = rng.standard_normal((1, hkv, tq, 32)).astype(np.float32)
    to = ops.flash_prefill(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(
        to, np.asarray(_j_ref_attn(j(q), j(k), j(v))), **TOL)
    np.testing.assert_allclose(
        to, np.asarray(_j_flash(j(q), j(k), j(v), chunk=16)), **TOL)


def test_flash_prefill_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 4, 40, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    jo = j_flash_pallas(j(q), j(k), j(v), q_blk=16, k_blk=16, interpret=True)
    to = ops.flash_prefill(t(q), t(k), t(v))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_cpu_tensors_never_count_launches():
    before = (pek.launches, pdk.launches, fpk.launches)
    test_encode_pages_writes_only_named_pages()
    q, pool, values, table, flushed = _decode_inputs()
    _decode_both(q, pool, values, table, flushed)
    x = torch.zeros((1, 2, 8, 32))
    ops.flash_prefill(x, x, x)
    assert (pek.launches, pdk.launches, fpk.launches) == before


def test_mixed_devices_raise():
    x = torch.zeros((1, 2, 8, 32))
    meta = torch.zeros((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_prefill(x, meta, x)


def test_kernel_sources_ship_beside_wrappers():
    """Every kernel module names its CUDA source, and the source exists."""
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
