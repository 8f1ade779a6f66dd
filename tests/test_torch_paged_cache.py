"""Port parity: the paged KV cache of ``repro_torch`` against the JAX
package on one token stream — a prefill per slot (partial, multi-page
and group-aligned prompts) then decode appends that cross two group
boundaries per slot, with slots dropping in and out of the active mask.

Afterwards every pool page except the never-read scratch page (which the
port skips instead of writing), the residual and the lengths must match:
value rows, residual and lengths byte for byte, key codes exactly, and
key stats — mins and maxes of rho/theta, whose float32 sqrt/atan2 differ
by ulps between the libraries — within 1e-6."""
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
from repro.core.cache_layout import PageAllocator as JAlloc  # noqa: E402
from repro.core.cache_layout import PagedLayout as JLayout  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.cache_layout import PageAllocator, PagedLayout  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402

H, D, G, S = 2, 32, 16, 3
PROMPTS = (9, 38, 32)          # partial group, two pages + rem, aligned
STEPS = 40


def _stream():
    rng = np.random.default_rng(0)
    prompts = [(rng.standard_normal((1, H, -(-t // G) * G, D)).astype(
        np.float32), rng.standard_normal((1, H, -(-t // G) * G, D)).astype(
        np.float32)) for t in PROMPTS]
    ks = rng.standard_normal((STEPS, S, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((STEPS, S, H, 1, D)).astype(np.float32)
    # slot 1 sits out a few steps; slot 2 joins late
    active = np.ones((STEPS, S), bool)
    active[5:9, 1] = False
    active[:3, 2] = False
    return prompts, ks, vs, active


@pytest.fixture(scope="module")
def caches():
    prompts, ks, vs, active = _stream()
    jlay = JLayout(page_size=G, num_pages=24, slots=S, pages_per_slot=6)
    lay = PagedLayout(page_size=G, num_pages=24, slots=S, pages_per_slot=6)
    jc = jpg.init_paged_cache(JQuantConfig(group_size=G), jlay, H, D,
                              dtype=jnp.float32)
    tc = tpg.init_paged_cache(QuantConfig(group_size=G), lay, H, D,
                              dtype=torch.float32, device="cpu")
    alloc = JAlloc(jlay)
    prefill = jax.jit(jpg.paged_prefill)
    lengths = np.zeros(S, int)
    for slot, ((k, v), tl) in enumerate(zip(prompts, PROMPTS)):
        assert alloc.alloc(slot, jlay.pages_for(tl + 1))
        row = alloc.table_np()[slot]
        jc = prefill(jc, jnp.asarray(slot), jnp.asarray(row),
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(tl))
        tpg.paged_prefill(tc, slot, torch.from_numpy(row), torch.from_numpy(k),
                          torch.from_numpy(v), tl)
        lengths[slot] = tl
    append = jax.jit(jpg.paged_append)
    for i in range(STEPS):
        for slot in range(S):
            if active[i, slot] and lengths[slot] % G == 0 and \
                    alloc.slot_pages(slot) <= lengths[slot] // G:
                assert alloc.alloc(slot, 1)
        table = alloc.table_np()
        jc = append(jc, jnp.asarray(ks[i]), jnp.asarray(vs[i]),
                    jnp.asarray(table), jnp.asarray(active[i]))
        tpg.paged_append(tc, torch.from_numpy(ks[i]), torch.from_numpy(vs[i]),
                         torch.from_numpy(table), torch.from_numpy(active[i]))
        lengths += active[i]
    return jc, tc, lengths, lay, alloc.table_np()


def test_stream_crosses_two_groups_per_slot(caches):
    _, _, lengths, _, _ = caches
    for t0, t1 in zip(PROMPTS, lengths):
        assert t1 // G - t0 // G >= 2


def test_lengths_and_residual_byte_equal(caches):
    jc, tc, lengths, _, _ = caches
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.lengths.numpy(), lengths)
    assert tc.key_residual.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tc.key_residual.float().numpy(),
        np.asarray(jc.key_residual.astype(jnp.float32)))


def test_value_pool_byte_equal_except_scratch(caches):
    jc, tc, _, lay, _ = caches
    keep = slice(0, lay.scratch_page)
    np.testing.assert_array_equal(tc.value_fp.numpy()[keep],
                                  np.asarray(jc.value_fp)[keep])


def test_key_pools_match_except_scratch(caches):
    jc, tc, _, lay, _ = caches
    keep = slice(0, lay.scratch_page)
    np.testing.assert_array_equal(tc.key_codes.numpy()[keep],
                                  np.asarray(jc.key_codes)[keep])
    for name, pool in tc.key_scales.items():
        np.testing.assert_allclose(pool.numpy()[keep],
                                   np.asarray(jc.key_scales[name])[keep],
                                   rtol=1e-6, atol=1e-6)
    # every written page really holds codes (not an all-zero pass)
    assert tc.key_codes.numpy()[keep].any()


def test_decode_attention_matches_jax(caches):
    """The page-native decode over the resulting cache (the paged_fused
    route of both packages) agrees within 1e-4, full and width-sliced."""
    jc, tc, lengths, lay, table = caches
    q = np.random.default_rng(7).standard_normal((S, 2 * H, D)).astype(
        np.float32)
    w = max(lay.pages_for(int(t) + 1) for t in lengths)
    jattn = jax.jit(jpg.paged_decode_attention, static_argnames="backend")
    for tab in (table, table[:, :w]):
        jo = jattn(jc, jnp.asarray(q), jnp.asarray(tab), backend="paged_fused")
        to = tpg.paged_decode_attention(tc, torch.from_numpy(q),
                                        torch.from_numpy(tab.copy()))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-4)


def test_append_rejects_misaligned_prefill_start():
    lay = PagedLayout(page_size=G, num_pages=4, slots=1, pages_per_slot=4)
    c = tpg.init_paged_cache(QuantConfig(group_size=G), lay, H, D,
                             dtype=torch.float32)
    x = torch.zeros((1, H, G, D))
    with pytest.raises(ValueError, match="page-aligned"):
        tpg.paged_prefill(c, 0, PageAllocator(lay).table()[0], x, x, 3,
                          start=5)
