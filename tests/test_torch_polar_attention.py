"""Port parity: the plain versions behind the dense-cache kernel wrappers
— ``polar_qk`` (LUT q.K scores, kernel #6) and ``polar_attention`` (fused
decode attention, kernel #5) — against the JAX package's interpret-mode
Pallas kernels and its ``"ref"`` oracles, at the shapes of
``tests/test_kernels.py:53-90`` with fp values, for r,t in {(4,4),
(3,3)}, to rtol = atol = 1e-4; and the plain model of kernel #5's split
walk (per-range partials, exact merge) against both. Inputs come from
numpy; codes and stats from JAX's encode, handed to both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import quantizers as tqz  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.kernels import polar_qk as qkk  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# the JAX references, jitted (eager dispatch of their many small ops costs
# more CPU than the comparisons themselves)
_j_encode = jax.jit(jops.polar_encode,
                    static_argnames=("r_bits", "t_bits", "group_size",
                                     "backend"))
_j_qk = jax.jit(jops.polar_qk_scores,
                static_argnames=("r_bits", "t_bits", "backend",
                                 "block_groups"))
_j_attn = jax.jit(jops.polar_decode_attention_grouped,
                  static_argnames=("r_bits", "t_bits", "backend",
                                   "block_groups"))


def t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, b, hkv, qh, d, g, gc, r, tb):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, qh, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, gc * g, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, gc * g, d)).astype(np.float32)
    enc = [np.array(x) for x in _j_encode(
        jnp.asarray(k), r_bits=r, t_bits=tb, group_size=g, backend="ref")]
    return q, enc, v


@pytest.mark.parametrize("d,g,gc,qh", [(32, 16, 4, 2), (64, 32, 2, 4),
                                       (128, 16, 2, 1)])
@pytest.mark.parametrize("r,tb", [(4, 4), (3, 3)])
def test_qk_scores_plain_matches_jax(d, g, gc, qh, r, tb):
    q, enc, _ = _inputs(2, 2, 2, qh, d, g, gc, r, tb)
    got = ops.polar_qk_scores(t(q), *(t(x) for x in enc), r_bits=r,
                              t_bits=tb).numpy()
    assert got.shape == (2, 2, qh, gc * g)
    jin = (jnp.asarray(q), *(jnp.asarray(x) for x in enc))
    np.testing.assert_allclose(
        got, np.asarray(_j_qk(*jin, r_bits=r, t_bits=tb, backend="ref")),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_j_qk(*jin, r_bits=r, t_bits=tb, backend="interpret",
                              block_groups=2)), **TOL)


def test_qk_scores_of_unwritten_groups_are_zero():
    """A group the cache has not flushed yet holds zero stats: its scores
    are finite zeros in both packages (the kernel writes every position;
    ``decode_attention`` masks them)."""
    q, enc, _ = _inputs(3, 1, 2, 2, 32, 16, 3, 4, 4)
    for x in enc:
        x[:, :, 2] = 0
    got = ops.polar_qk_scores(t(q), *(t(x) for x in enc)).numpy()
    assert (got[..., 32:] == 0).all()
    np.testing.assert_allclose(got, np.asarray(_j_qk(
        jnp.asarray(q), *(jnp.asarray(x) for x in enc), backend="ref")),
        **TOL)


@pytest.mark.parametrize("length_frac", [0.3, 1.0])
@pytest.mark.parametrize("r,tb", [(4, 4), (3, 3)])
def test_decode_attention_plain_matches_jax(length_frac, r, tb):
    """``tests/test_kernels.py:75`` with fp values: partials (acc, m, l) of
    the grouped segment at a group-aligned length."""
    b, hkv, qh, d, g, gc = 2, 2, 4, 32, 16, 4
    q, enc, v = _inputs(3, b, hkv, qh, d, g, gc, r, tb)
    length = int(gc * g * length_frac) // g * g
    got = ops.polar_decode_attention_grouped(
        t(q), *(t(x) for x in enc), t(v),
        torch.full((b,), length, dtype=torch.int32), r_bits=r, t_bits=tb)
    jin = (jnp.asarray(q), *(jnp.asarray(x) for x in enc), jnp.asarray(v),
           None, None, jnp.asarray(length, jnp.int32))
    for backend in ("ref", "interpret"):
        want = _j_attn(*jin, r_bits=r, t_bits=tb, backend=backend,
                       block_groups=2)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_decode_attention_per_row_lengths_and_poisoned_dead_rows():
    """Per-row lengths (0, a partial group, the full buffer) with NaN in
    every value row past each length: the port's plain version zeroes dead
    rows as the kernels do, and equals JAX's oracle on clean rows. JAX's
    interpret-mode kernel multiplies the dead rows by p = 0 and returns
    NaN for the rows whose live groups hold NaN (ROADMAP queue 3)."""
    b, hkv, qh, d, g, gc = 3, 2, 4, 32, 16, 4
    q, enc, v = _inputs(4, b, hkv, qh, d, g, gc, 4, 4)
    length = np.array([0, 23, 64], np.int32)
    clean = v.copy()
    for i, n in enumerate(length):
        v[i, :, n:] = np.nan
    got = [x.numpy() for x in pak.polar_decode_attention_grouped_plain(
        t(q), *(t(x) for x in enc), t(v), t(length))]
    for x in got:
        assert np.isfinite(x).all()
    want = _j_attn(jnp.asarray(q), *(jnp.asarray(x) for x in enc),
                   jnp.asarray(clean), None, None, jnp.asarray(length),
                   backend="ref")
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL)
    assert got[2][0].max() == 0.0               # length 0: empty partials
    poisoned = _j_attn(jnp.asarray(q), *(jnp.asarray(x) for x in enc),
                       jnp.asarray(v), None, None, jnp.asarray(length),
                       backend="interpret", block_groups=2)
    assert np.isnan(np.asarray(poisoned[0])[1]).any()


def _dense_split_partials(q, enc, values, length, nsplit, **vq):
    """The plain model of kernel #5's split walk: per range of
    ``paged_decode.split_ranges(G, nsplit)``, the plain version over that
    range's groups and value rows alone (the groups outside it masked out),
    with each row's length cut to the range."""
    g, gc = enc[0].shape[3], enc[0].shape[2]
    parts = []
    for lo, hi in pdk.split_ranges(gc, nsplit):
        rows = slice(lo * g, hi * g)
        ln = torch.clamp(length - lo * g, 0, (hi - lo) * g).to(torch.int32)
        kw = {k: v[:, :, rows].contiguous() for k, v in vq.items()}
        parts.append(pak.polar_decode_attention_grouped_plain(
            q, *(x[:, :, lo:hi].contiguous() for x in enc),
            values[:, :, rows].contiguous(), ln, **kw))
    return parts


def _normalized(acc, l):
    return acc / torch.where(l == 0, 1.0, l)[..., None]


# nsplit 5 is the static serving shape's plan (8 rows x 4 kv heads x 9
# groups); 3 and 9 cut 9 groups into 3-group and 1-group ranges
@pytest.mark.parametrize("nsplit", [3, 5, 9])
@pytest.mark.parametrize("vkind", ["bf16", "u8"])
def test_dense_split_then_merge_matches_unsplit_and_jax(vkind, nsplit):
    """Kernel #5's split-then-merge, in plain PyTorch: each range's
    partials merged by ``ops.merge_softmax_partials`` equal the unsplit
    plain version and JAX's interpret-mode kernel (clean rows) to 1e-4,
    with NaN in every value row (uint8: scale and zero) and stat row past
    each row's length, a row of length 0 and partial groups; a range that
    holds no live group gives m = -1e30, l = 0 and leaves the merge
    finite."""
    b, hkv, qh, d, g, gc = 4, 2, 4, 32, 16, 9
    q, enc, v = _inputs(6, b, hkv, qh, d, g, gc, 4, 4)
    q = q * d ** -0.5
    length = np.array([0, 23, 80, gc * g], np.int32)
    if vkind == "bf16":
        vt = t(v).to(torch.bfloat16)
        clean = [vt]
        jv = [jnp.asarray(vt.float().numpy()).astype(jnp.bfloat16), None,
              None]
    else:
        qv = tqz.encode_values(t(v), 4)
        clean = [qv.codes, qv.scale, qv.zero]
        jv = [jnp.asarray(x.numpy()) for x in clean]
    want = _j_attn(jnp.asarray(q), *(jnp.asarray(x) for x in enc), *jv,
                   jnp.asarray(length), backend="interpret", block_groups=3)
    want = [t(x) for x in want]
    poisoned = [x.clone() for x in clean]
    encp = [x.copy() for x in enc]
    for i, n in enumerate(length):
        for x in poisoned[-2:] if vkind == "u8" else poisoned:
            x[i, :, n:] = float("nan")
        for x in encp[1:]:
            x[i, :, -(-n // g):] = np.nan
    vq = ({"vscale": poisoned[1], "vzero": poisoned[2]} if vkind == "u8"
          else {})
    qt, enct = t(q), [t(x) for x in encp]
    acc, m, l = pak.polar_decode_attention_grouped_plain(
        qt, *enct, poisoned[0], t(length), **vq)
    parts = _dense_split_partials(qt, enct, poisoned[0], t(length), nsplit,
                                  **vq)
    assert len(parts) == min(nsplit, gc)
    for pa, pm, pl in parts:
        assert torch.isfinite(pa).all() and torch.isfinite(pm).all()
    got = ops.merge_softmax_partials(parts)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _normalized(acc, l), **TOL)
    torch.testing.assert_close(got, _normalized(want[0], want[2]), **TOL)
    assert float(got[0].abs().max()) == 0.0       # length 0: empty output
    # the merged softmax stats too: max of the m's, rescaled sum of the l's
    m_tot = torch.stack([x[1] for x in parts]).amax(0)
    l_tot = sum(x[2] * torch.exp(x[1] - m_tot) for x in parts)
    for a, w in ((m_tot, m), (l_tot, l), (m_tot, want[1]), (l_tot, want[2])):
        torch.testing.assert_close(a, w, **TOL)


def test_cpu_tensors_never_count_launches():
    before = (qkk.launches, pak.launches, pak.launches_split)
    test_qk_scores_of_unwritten_groups_are_zero()
    test_decode_attention_plain_matches_jax(1.0, 4, 4)
    test_dense_split_then_merge_matches_unsplit_and_jax("u8", 5)
    assert (qkk.launches, pak.launches, pak.launches_split) == before
