"""Port parity: the mask modes of the whole-prompt attention (the plain
version of the flash-prefill kernel, ``repro_torch/core/attention.py``)
and the ring layout (``repro_torch/core/cache_layout.py``) against the
JAX package.

``prefix`` (PaliGemma's prefix-LM: bidirectional over each row's first
``prefix_len[b]`` positions, causal after) and ``local`` (RecurrentGemma's
sliding window) against JAX's ``reference_attention`` and jnp
``flash_attention`` on the same numpy inputs: GQA 4:1 and MQA, d 64 and
256, T off the kernels' 64-row tile, rtol = atol = 1e-5. ``RingLayout``
and ``ring_segments`` equal JAX's over a sweep of (t, capacity)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache_layout as jlay  # noqa: E402
from repro.core.attention import flash_attention  # noqa: E402
from repro.core.attention import reference_attention as j_ref  # noqa: E402
from repro_torch.core import cache_layout as tlay  # noqa: E402
from repro_torch.core.attention import reference_attention  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

_j_ref = jax.jit(j_ref, static_argnames=("mode", "window"))
_j_flash = jax.jit(flash_attention, static_argnames=("mode", "window",
                                                     "chunk"))

# (batch, heads, kv heads, T, d, mode, window, prefix_len): paligemma's
# MQA at d 256 with a prefix per row (one of 0, one past T), GQA 4:1 at
# d 64, recurrentgemma's MQA window at d 256 (narrower than JAX's chunk,
# wider than T) and a GQA window at d 64; every T off the 64-row tile
_CASES = {
    "prefix-mqa-d256": (2, 8, 1, 77, 256, "prefix", 0, (20, 65)),
    "prefix-gqa-d64": (3, 8, 2, 130, 64, "prefix", 0, (0, 64, 200)),
    "prefix-rows-d64": (2, 4, 1, 50, 64, "prefix", 0, (49, 1)),
    "local-mqa-d256": (2, 16, 1, 90, 256, "local", 30, None),
    "local-gqa-d64": (2, 8, 2, 150, 64, "local", 64, None),
    "local-wide-d64": (1, 4, 1, 70, 64, "local", 500, None),
    "local-one-d64": (1, 4, 1, 33, 64, "local", 1, None),
}


def _inputs(case, seed=0):
    b, h, hkv, t, d, mode, window, plen = _CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    pl = None if plen is None else np.asarray(plen, np.int32)
    return q, k, v, mode, window, pl


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_attention_masks_match_jax(case):
    q, k, v, mode, window, pl = _inputs(case)
    jpl = None if pl is None else jnp.asarray(pl)
    want = np.asarray(_j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mode=mode, window=window, prefix_len=jpl))
    # JAX's chunked flash attention, with a chunk that cuts T
    flash = np.asarray(_j_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mode=mode, window=window,
                                prefix_len=jpl, chunk=32))
    tpl = None if pl is None else torch.from_numpy(pl)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), mode=mode, window=window,
                              prefix_len=tpl).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)
    # the kernel's entry on CPU tensors runs the same plain version
    via_ops = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), mode=mode,
                                window=window, prefix_len=tpl).numpy()
    np.testing.assert_array_equal(via_ops, got)


def test_prefix_and_local_masks_are_what_they_claim():
    """Row b attends bidirectionally over its first prefix_len[b] keys and
    causally after; a local row sees exactly its last ``window`` keys."""
    q, k, v, _, _, _ = _inputs("prefix-rows-d64")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    pl = torch.tensor([49, 1], dtype=torch.int32)
    base = reference_attention(q, k, v, mode="prefix", prefix_len=pl)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 48] += 1.0          # inside row 0's prefix, past row 1's
    v2[:, :, 48] += 1.0
    moved = reference_attention(q, k2, v2, mode="prefix", prefix_len=pl)
    assert not torch.allclose(moved[0, :, :48], base[0, :, :48])
    torch.testing.assert_close(moved[1, :, :48], base[1, :, :48], rtol=0,
                               atol=0)
    loc = reference_attention(q, k, v, mode="local", window=5)
    k3, v3 = k.clone(), v.clone()
    k3[:, :, 10] += 1.0
    v3[:, :, 10] += 1.0
    moved = reference_attention(q, k3, v3, mode="local", window=5)
    changed = [i for i in range(q.shape[2])
               if not torch.equal(moved[:, :, i], loc[:, :, i])]
    assert changed == list(range(10, 15))


def test_flash_prefill_entry_rejects_bad_masks():
    q = torch.zeros((2, 4, 8, 64))
    k = torch.zeros((2, 1, 8, 64))
    pl = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix_len"):
        fpk.flash_prefill(q, k, k, mode="prefix")
    with pytest.raises(ValueError, match="prefix_len"):
        fpk.flash_prefill(q, k, k, mode="causal", prefix_len=pl)
    with pytest.raises(ValueError, match="window"):
        fpk.flash_prefill(q, k, k, mode="local")
    with pytest.raises(ValueError, match="mask mode"):
        fpk.flash_prefill(q, k, k, mode="window")


@pytest.mark.parametrize("cap", [1, 16, 64, 100])
def test_ring_layout_matches_jax(cap):
    jr, tr = jlay.RingLayout(cap), tlay.RingLayout(cap)
    jl, tl = jlay.LinearLayout(cap), tlay.LinearLayout(cap)
    for t in range(0, 3 * cap + 5):
        assert tlay.ring_segments(t, cap) == jlay.ring_segments(t, cap)
        assert tr.copy_segments(t) == jr.copy_segments(t)
        assert tr.prefill_offset(t) == jr.prefill_offset(t)
        assert tr.token_slot(t) == jr.token_slot(t)
        assert tr.group_slot(t, cap) == jr.group_slot(t, cap)
        if t <= cap:
            assert tl.copy_segments(t) == jl.copy_segments(t)
            assert tl.prefill_offset(t) == jl.prefill_offset(t) == 0
        else:
            with pytest.raises(ValueError):
                tl.copy_segments(t)
        # the segments place positions [max(0, t - cap), t) at pos % cap
        slots = {}
        for lo, hi, dst in tlay.ring_segments(t, cap):
            for p in range(lo, hi):
                slots[p] = dst + p - lo
        assert slots == {p: p % cap for p in range(max(0, t - cap), t)}
