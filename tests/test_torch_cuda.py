"""The port's hand-written CUDA kernels against their plain versions on
the card, at small shapes. Marked ``cuda``: without a GPU every test here
skips (the decision is made inside a fixture, never at import).

On a machine with the card (this file needs torch only, not JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import paged_prefill as ppk  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.kernels import polar_encode as pek  # noqa: E402
from repro_torch.kernels import polar_qk as qkk  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _encode_keys(dev, gen, shape, dtype, offset=0):
    """Random keys with zero pairs (the theta pin) and denormals (the
    flush) in the first group; ``offset`` elements into a raw buffer makes
    them unaligned (the kernel's one-pair-a-thread body)."""
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k[0, 0, :3, :2] = 0.0
    k[0, 0, 3, 0] = 1e-39
    k[0, -1, 5, shape[-1] // 2] = -1e-40
    k[-1, 0, 1, :] = 0.0
    if offset:
        raw = torch.empty(k.numel() + offset, dtype=dtype, device=dev)
        k = raw[offset:].view(shape).copy_(k)
    return k


# d, g and offset: the served d 64 at every group size the cluster splits
# (g 16 leaves 4 tokens a block), d 32 / 40 / 48 / 128 (d 40: 5 threads a
# token), a group size that is not a multiple of the cluster, and the
# one-pair-a-thread body: d 36 (P % 4 != 0) and keys at a 1-element offset
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g,offset", [
    (64, 16, 0), (64, 32, 0), (64, 64, 0), (64, 128, 0), (32, 16, 0),
    (128, 32, 0), (128, 128, 0), (48, 64, 0), (64, 10, 0), (40, 32, 0),
    (36, 32, 0), (64, 128, 1), (256, 128, 0), (256, 32, 0)])
def test_encode_kernel_codes_exact(dev, dtype, d, g, offset):
    k = _encode_keys(dev, _gen(dev), (2, 3, 4 * g, d), dtype, offset)
    n = pek.launches
    got = pek.polar_encode(k, group_size=g)
    ref = pek.polar_encode_plain(k, group_size=g)
    assert pek.launches == n + 1
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)


# the decode form: every slot's residual group, pages of the flushing slots
_FLUSH = {"none": [-1] * 8, "one": [-1, -1, 5, -1, -1, -1, -1, -1],
          "some": [2, -1, 7, -1, -1, 0, -1, 9],
          "all": [3, 8, 1, 6, 0, 4, 9, 2]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flush", sorted(_FLUSH))
@pytest.mark.parametrize("g", [16, 32, 64, 128])
def test_encode_pages_kernel_skips_negative_pages(dev, g, flush, dtype):
    d, h, pp = 64, 4, 10
    k = _encode_keys(dev, _gen(dev, 1), (8, h, g, d), dtype)
    pages = torch.tensor(_FLUSH[flush], dtype=torch.int32,
                         device=dev)[:, None]

    def pools():
        return [torch.zeros((pp, h, g, d // 2), dtype=torch.uint8,
                            device=dev)] + \
            [torch.zeros((pp, h, 1, d // 2), device=dev) for _ in range(4)]

    a, b = pools(), pools()
    n = pek.launches
    pek.polar_encode_pages(k, pages, *a)
    assert pek.launches == n + 1
    pek.polar_encode_pages_plain(k, pages, *b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    skipped = [i for i in range(pp) if i not in _FLUSH[flush]]
    for x in a:
        assert not x[skipped].any()


# (slots, kv heads, query heads, flushed per slot, table width, pool
# pages): a small mixed case; the long-context shape, 1 slot x 32 pages
# (4096 tokens); 8 slots flushed 0..896, so that some splits hold no live
# page. Tables are width slices of a wider table, dead entries point at a
# NaN-poisoned scratch page.
_DECODE_CASES = {
    "mixed": (4, 2, 8, [0, 128, 384, 256], 3, 12),
    "long": (1, 4, 8, [4096], 32, 40),
    "ragged8": (8, 4, 8, [0, 128, 256, 384, 512, 640, 768, 896], 8, 65),
}


@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(dev, vdtype, case):
    s, hkv, qh, fl, n, pp = _DECODE_CASES[case]
    d, g = 64, 128
    gen = _gen(dev, 2)
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    enc = ops.polar_encode(k, group_size=g)
    pool = [x.reshape(pp, hkv, *x.shape[-2:]).contiguous() for x in enc]
    values = torch.randn((pp, hkv, g, d), generator=gen, device=dev).to(vdtype)
    scratch = pp - 1
    for x in pool[1:]:
        x[scratch] = float("nan")
    values[scratch] = float("nan")
    table = torch.full((s, n + 1), scratch, dtype=torch.int32, device=dev)
    perm = torch.randperm(scratch, generator=gen, device=dev).to(torch.int32)
    used = 0
    for sl, f in enumerate(fl):
        table[sl, :f // g] = perm[used:used + f // g]
        used += f // g
    flushed = torch.tensor(fl, dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    sliced = table[:, :n]                 # a non-contiguous width slice
    if s * hkv < 132:                     # the host splits the page walk
        assert pdk.plan_splits(s, hkv, n) > 1
    got = pdk.polar_paged_decode_grouped(q, *pool, values, sliced, flushed)
    ref = pdk.polar_paged_decode_grouped_plain(q, *pool, values, sliced,
                                               flushed)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _dense_groups(dev, gen, b, hkv, d, g, gc, r=4, t=4):
    """Dense (B, Hkv, G, g, P) codes and stats from the encode kernel."""
    k = torch.randn((b, hkv, gc * g, d), generator=gen, device=dev)
    return list(pek.polar_encode(k, r_bits=r, t_bits=t, group_size=g))


# the shapes of tests/test_kernels.py's sweep, the static serving path's
# (Hkv 4, Qh 8, d 64, g 128, 9 groups), g 16 / 128 with Qh 1, 8, 12, and
# the kernel's generic path: d outside (32, 64, 128), g % 4 != 0, codes
# that are not 16-byte aligned (a contiguous view at a 1-byte offset)
@pytest.mark.parametrize("d,g,gc,qh,offset", [
    (32, 16, 4, 2, 0), (64, 32, 2, 4, 0), (128, 16, 2, 1, 0),
    (64, 128, 9, 8, 0), (128, 32, 3, 12, 0), (64, 16, 5, 1, 0),
    (64, 16, 5, 8, 0), (64, 16, 5, 12, 0), (64, 128, 3, 1, 0),
    (64, 128, 3, 12, 0), (48, 16, 3, 8, 0), (64, 10, 3, 8, 0),
    (64, 16, 3, 8, 1)])
@pytest.mark.parametrize("r,t", [(4, 4), (3, 3)])
def test_qk_kernel_matches_plain(dev, d, g, gc, qh, offset, r, t):
    """Kernel #6 writes every score: the last group holds zero stats (not
    yet written), and with three or more groups so does one in the middle;
    both must score to finite zeros, as the plain version."""
    gen = _gen(dev, 10)
    b, hkv = 2, 2
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc, r, t)
    zero = [gc - 1] + ([gc // 2] if gc >= 3 else [])
    for x in enc:
        x[:, :, zero] = 0
    if offset:
        raw = torch.empty(enc[0].numel() + offset, dtype=torch.uint8,
                          device=dev)
        enc[0] = raw[offset:].view(enc[0].shape).copy_(enc[0])
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev)
    n = qkk.launches
    got = qkk.polar_qk_scores(q, *enc, r_bits=r, t_bits=t)
    assert qkk.launches == n + 1
    ref = qkk.polar_qk_scores_plain(q, *enc, r_bits=r, t_bits=t)
    torch.cuda.synchronize()
    assert got.shape == (b, hkv, qh, gc * g)
    for z in zero:
        blk = got[..., z * g:(z + 1) * g]
        assert torch.equal(blk, torch.zeros_like(blk))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# (rows, kv heads, d, groups, row lengths): a small case (4 splits); the
# static serving shape, 8 rows x 4 kv heads x 9 groups (5 splits, some
# holding no live group); 66 rows x 4 kv heads, enough blocks unsplit
# (one split, still the split body); d 48, which the split body does not
# take. Every case has a row of length 0 and a partial group.
_DENSE_CASES = {
    "small": (4, 2, 64, 4, [0, 300, 384, 512]),
    "static": (8, 4, 64, 9, [1024, 900, 0, 128, 1, 513, 640, 1152]),
    "wide": (66, 4, 64, 3, [(37 * i) % 385 for i in range(66)]),
    "d48": (4, 2, 48, 4, [0, 300, 384, 511]),
}


def _dense_case(dev, gen, case, t_bits):
    """q, codes and stats of a ``_DENSE_CASES`` entry (stats past each
    row's length NaN-poisoned) and its int32 lengths."""
    b, hkv, d, gc, lens = _DENSE_CASES[case]
    g, qh = 128, 8
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc, 4, t_bits)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        for x in enc[1:]:
            x[i, :, -(-n // g):] = float("nan")
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    return q, enc, length


def _dense_launch(case, fn):
    """``fn()``: one launch of kernel #5, on the split body unless
    d % 32 != 0, with the host's split count of the case."""
    b, hkv, d, gc, _ = _DENSE_CASES[case]
    n, n_split = pak.launches, pak.launches_split
    out = fn()
    assert pak.launches == n + 1
    assert pak.launches_split == n_split + (d % 32 == 0)
    want = {"small": 4, "static": 5, "wide": 1}.get(case)
    assert want is None or pdk.plan_splits(b, hkv, gc) == want
    return out


def _check_dense(got, ref, length):
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all(), "NaN leaked from a dead row"
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    empty = length == 0                            # length 0: empty partials
    assert float(got[0][empty].abs().max()) == 0.0
    assert float(got[2][empty].abs().max()) == 0.0


@pytest.mark.parametrize("case", sorted(_DENSE_CASES))
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_bits", [4, 3])
def test_polar_attention_kernel_matches_plain(dev, vdtype, t_bits, case):
    """Kernel #5 over the dense buffers: rows at 0, a partial group, whole
    groups and the full buffer; value rows and stats past each row's length
    NaN-poisoned."""
    gen = _gen(dev, 11)
    q, enc, length = _dense_case(dev, gen, case, t_bits)
    b, hkv, _, d = q.shape
    t_cap = enc[0].shape[2] * enc[0].shape[3]
    values = torch.randn((b, hkv, t_cap, d), generator=gen, device=dev).to(
        vdtype)
    for i, n in enumerate(length.tolist()):
        values[i, :, n:] = float("nan")
    got = _dense_launch(case, lambda: pak.polar_decode_attention_grouped(
        q, *enc, values, length, t_bits=t_bits))
    ref = pak.polar_decode_attention_grouped_plain(q, *enc, values, length,
                                                   t_bits=t_bits)
    _check_dense(got, ref, length)


def test_dense_full_decode_on_card_matches_plain(dev):
    """ops.polar_decode_attention_full (kernel #5 + residual merge) against
    the same entry with the plain version swapped in; bf16 values and
    residual as the static engine holds them, () and (B,) lengths."""
    from unittest import mock
    b, hkv, qh, d, g, gc = 3, 4, 8, 64, 128, 3
    gen = _gen(dev, 12)
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    values = torch.randn((b, hkv, gc * g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    res = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((b, hkv * qh, d), generator=gen, device=dev)
    for length in (torch.tensor(200, dtype=torch.int32, device=dev),
                   torch.tensor([5, 256, 383], dtype=torch.int32,
                                device=dev)):
        got = ops.polar_decode_attention_full(q, *enc, res, values, length)
        with mock.patch.object(pak, "polar_decode_attention_grouped",
                               pak.polar_decode_attention_grouped_plain):
            ref = ops.polar_decode_attention_full(q, *enc, res, values,
                                                  length)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_new_kernel_wrappers_reject_bad_inputs(dev):
    gen = _gen(dev, 13)
    enc = _dense_groups(dev, gen, 1, 2, 64, 16, 2)
    q = torch.randn((1, 2, 4, 64), generator=gen, device=dev)
    v = torch.zeros((1, 2, 32, 64), device=dev)
    ln = torch.tensor([16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        qkk.polar_qk_scores(q.double(), *enc)
    with pytest.raises(ValueError, match="stats"):
        qkk.polar_qk_scores(q, enc[0], *(x.transpose(-1, -2) for x in
                                         enc[1:]))
    with pytest.raises(ValueError, match="length"):
        pak.polar_decode_attention_grouped(q, *enc, v, ln.long())
    with pytest.raises(ValueError, match="values"):
        pak.polar_decode_attention_grouped(q, *enc, v[:, :, :16], ln)
    with pytest.raises(ValueError, match="codes"):
        pak.polar_decode_attention_grouped(q, enc[0][..., :16], *enc[1:], v,
                                           ln)


# (batch, heads, kv heads, Tq, Tk, d, dtype, causal, offset): fp32 runs
# the FMA body, bf16 the tensor-core body — the main-path shape (32 heads
# / 4 kv heads, 1024 tokens), ragged Tq, d 32 / 64 / 128, a batch of 8,
# Tq != Tk both ways and a non-causal call — except bf16 whose pointers
# are not 16-byte aligned (contiguous views at a 1-element offset), which
# takes the FMA body too
_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,dtype,causal,offset", [
    (2, 8, 2, 200, 200, 64, _F32, True, 0),
    (2, 8, 2, 64, 64, 32, _F32, True, 0),
    (2, 8, 2, 130, 130, 128, _BF16, True, 0),
    (1, 32, 4, 1024, 1024, 64, _BF16, True, 0),
    (2, 8, 2, 1, 1, 64, _BF16, True, 0), (2, 8, 2, 63, 63, 64, _BF16, True, 0),
    (2, 8, 2, 65, 65, 64, _BF16, True, 0),
    (1, 8, 2, 1000, 1000, 64, _BF16, True, 0),
    (2, 8, 2, 200, 200, 32, _BF16, True, 0),
    (2, 8, 2, 200, 200, 128, _BF16, True, 0),
    (8, 8, 2, 130, 130, 64, _BF16, True, 0),
    (2, 8, 2, 65, 200, 64, _BF16, True, 0),
    (2, 8, 2, 200, 65, 64, _BF16, True, 0),
    (2, 8, 2, 100, 150, 64, _BF16, False, 0),
    (2, 8, 2, 100, 150, 64, _F32, False, 0),
    (1, 8, 2, 77, 77, 64, _BF16, True, 1)])
def test_flash_prefill_kernel_matches_plain(dev, b, h, hkv, tq, tk, d, dtype,
                                            causal, offset):
    gen = _gen(dev, 3)

    def randn(shape):
        raw = torch.empty(int(np.prod(shape)) + offset, dtype=dtype,
                          device=dev)
        x = raw[offset:].view(shape)
        return x.copy_(torch.randn(shape, generator=gen, device=dev))

    q = randn((b, h, tq, d))
    k = randn((b, hkv, tk, d))
    v = randn((b, hkv, tk, d))
    n = fpk.launches
    mode = "causal" if causal else "full"
    got = fpk.flash_prefill(q, k, v, mode=mode)
    assert fpk.launches == n + 1
    ref = fpk.flash_prefill_plain(q, k, v, mode=mode)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def _prefill_pools(dev, gen, pp, hkv, g, d):
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    enc = ops.polar_encode(k, group_size=g)
    pool = [x.reshape(pp, hkv, *x.shape[-2:]).contiguous() for x in enc]
    values = torch.randn((pp, hkv, g, d), generator=gen, device=dev)
    return pool, values


# (start, chunk_len, row width, head_dim): first chunk, fragmented prefix,
# ragged chunks on width-sliced rows, the prefix phase's start 1024 on an
# 8-page row and start 2048 on a 16-page row, chunk_len 1 / 77 / 255, and
# d 32 / 128; each with fp32 and bf16 chunk K/V and value pool (bf16 with
# bf16 runs the tensor-core body, anything fp32 the FMA body)
@pytest.mark.parametrize("start,clen,width,d", [
    (0, 256, 6, 64), (384, 256, 6, 64), (384, 77, 4, 64), (512, 1, 6, 64),
    (1024, 255, 8, 64), (1024, 77, 8, 64), (2048, 1, 16, 64),
    (2048, 255, 16, 64), (1024, 77, 8, 32), (1024, 255, 8, 128)])
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(dev, start, clen, width, d,
                                            kvdtype, vdtype):
    """Kernel #4 against its plain version at the serving shapes (Hkv 4,
    Qh 8, g 128, Tc 256), NaN on the scratch page behind every dead entry,
    on live value rows past ``start`` and on chunk K/V rows past
    ``chunk_len``. Both bodies at 1e-4: the FMA body sums fp32 products;
    the tensor-core body carries fp32 q, k~ and p as bf16 hi + lo pairs
    (relative error per product below ~1.1e-5) and both sides read the same
    bf16 values. bf16 inputs must take the tensor-core body."""
    hkv, qh, g, tc, pp = 4, 8, 128, 256, 20
    scratch = pp - 1
    gen = _gen(dev, 5)
    pool, values = _prefill_pools(dev, gen, pp, hkv, g, d)
    values = values.to(vdtype)
    row = torch.randperm(scratch, generator=gen, device=dev)[:width].to(
        torch.int32)
    row[start // g + (clen + g - 1) // g:] = scratch
    for x in pool[1:]:
        x[scratch] = float("nan")
    values[scratch] = float("nan")
    if start // g < width:
        values[int(row[start // g])] = float("nan")   # dead: at/past start
    q = torch.randn((hkv, qh * tc, d), generator=gen, device=dev) * d ** -0.5
    kc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    vc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    n, n_mma = ppk.launches, ppk.launches_mma
    got = ppk.polar_paged_prefill_grouped(q, kc, vc, *pool, values, row,
                                          start, clen)
    assert ppk.launches == n + 1
    bf16 = kvdtype == vdtype == torch.bfloat16
    assert ppk.launches_mma == n_mma + int(bf16)
    ref = ppk.polar_paged_prefill_grouped_plain(q, kc, vc, *pool, values,
                                                row, start, clen)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_paged_prefill_kernel_bf16_values_and_ops_entry(dev):
    """bf16 value pool and the ops entry (fold, pre-scale, unfold) in the
    model's bf16 dtype: within one bf16 step (2^-7) of the plain route."""
    hkv, qh, d, g, tc, pp = 4, 8, 64, 128, 256, 12
    gen = _gen(dev, 6)
    pool, values = _prefill_pools(dev, gen, pp, hkv, g, d)
    values = values.to(torch.bfloat16)
    row = torch.tensor([4, 8, 1, 6, 10, 0, 3, 2], dtype=torch.int32,
                       device=dev)
    q = torch.randn((1, hkv * qh, tc, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc = torch.randn((1, hkv, tc, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vc = torch.randn((1, hkv, tc, d), generator=gen, device=dev).to(
        torch.bfloat16)
    got = ops.polar_paged_prefill_attention(q, kc, vc, *pool, values, row,
                                            1024, 200)
    ref = ppk.polar_paged_prefill_grouped_plain(
        (q.float() * d ** -0.5).reshape(hkv, qh * tc, d), kc[0], vc[0],
        *pool, values, row, 1024, 200).reshape(1, hkv * qh, tc, d)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=2 ** -7)


def test_copy_pool_pages_on_card(dev):
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.core.quantizers import QuantConfig
    lay = PagedLayout(page_size=128, num_pages=6, slots=2, pages_per_slot=3)
    c = pgc.init_paged_cache(QuantConfig(), lay, 4, 64)
    assert c.key_codes.is_cuda
    gen = _gen(dev, 7)
    c.key_codes.copy_(torch.randint(0, 256, c.key_codes.shape, generator=gen,
                                    device=dev, dtype=torch.int32))
    for x in (*c.key_scales.values(), c.value_fp):
        x.copy_(torch.randn(x.shape, generator=gen, device=dev))
    before = [x.clone() for x in (c.key_codes, *c.key_scales.values(),
                                  c.value_fp)]
    pgc.copy_pool_pages(c, 4, 1)
    for b, x in zip(before, (c.key_codes, *c.key_scales.values(),
                             c.value_fp)):
        assert torch.equal(x[1], b[4])
        keep = [i for i in range(x.shape[0]) if i != 1]
        assert torch.equal(x[keep], b[keep])


def test_kernel_wrappers_reject_bad_inputs(dev):
    x = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fpk.flash_prefill(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        fpk.flash_prefill(x.transpose(1, 2), x, x)


def test_engine_runs_on_card_by_default(dev):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"), dtype="bfloat16")
    m = get_model(cfg)
    params = m.init(generator=_gen(dev, 4))
    assert params["embed"].is_cuda
    before = pdk.launches
    eng = ContinuousBatchingEngine(m, params, max_slots=2, max_len=128)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (40,))
                    .astype(np.int32), max_new_tokens=8) for i in range(3)]
    out = eng.run(reqs, GenerationConfig())
    assert all(r.done_tokens == 8 for r in out["requests"])
    assert pdk.launches > before


def test_chunked_prefix_engine_on_card(dev):
    """Chunked prefill with the prefix cache on the card: the paged-prefill
    kernel runs, pages are adopted, and the greedy streams equal those of
    the unshared chunked run."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"), dtype="bfloat16")
    m = get_model(cfg)
    params = m.init(generator=_gen(dev, 8))
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, (96,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
             for t in rng.integers(8, 40, 4)]

    def reqs():
        return [Request(rid=i, prompt=np.concatenate([shared, t]),
                        max_new_tokens=6,
                        arrival_time=0.0 if i == 0 else 1000.0)
                for i, t in enumerate(tails)]

    outs = {}
    for reuse in (False, True):
        before = ppk.launches
        eng = ContinuousBatchingEngine(m, params, max_slots=2, max_len=192,
                                       prefill_chunk=32, prefix_cache=reuse)
        out = eng.run(reqs(), GenerationConfig())
        assert ppk.launches > before
        outs[reuse] = out
    assert outs[True]["adopted_pages"] > 0
    assert outs[True]["cow_splits"] == 0
    assert {r.rid: r.out_tokens for r in outs[True]["requests"]} == \
        {r.rid: r.out_tokens for r in outs[False]["requests"]}


def test_paged_backends_agree_on_card(dev):
    """One fragmented paged cache with a NaN-poisoned scratch page: the
    three decode backends (score-only LUT kernel + softmax over the
    gathered view, the fused dense kernel over it, the page walk) agree
    within 1e-4 and stay finite."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.core.quantizers import QuantConfig
    s, h, d, g = 3, 4, 64, 128
    lay = PagedLayout(page_size=g, num_pages=10, slots=s, pages_per_slot=4)
    c = pgc.init_paged_cache(QuantConfig(), lay, h, d)
    gen = _gen(dev, 14)
    rows = [[6, 1], [3, 8, 0], [9]]
    table = torch.full((s, 4), lay.scratch_page, dtype=torch.int32,
                       device=dev)
    for slot, (row, tl) in enumerate(zip(rows, (200, 300, 77))):
        table[slot, :len(row)] = torch.tensor(row)
        tp = len(row) * g
        k = torch.randn((1, h, tp, d), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((1, h, tp, d), generator=gen, device=dev).to(
            torch.bfloat16)
        pgc.paged_prefill(c, slot, table[slot], k, v, tl)
    for x in (*c.key_scales.values(), c.value_fp):
        x[lay.scratch_page] = float("nan")
    q = torch.randn((s, h * 8, d), generator=gen, device=dev)
    outs = {}
    for backend in pgc.DECODE_BACKENDS:
        before = (qkk.launches, pak.launches, pdk.launches)
        outs[backend] = pgc.paged_decode_attention(
            c, q, table[:, :3], backend=backend)
        ran = [a - b for a, b in zip((qkk.launches, pak.launches,
                                      pdk.launches), before)]
        assert ran == {"jnp": [1, 0, 0], "gathered": [0, 1, 0],
                       "paged_fused": [0, 0, 1]}[backend]
    torch.cuda.synchronize()
    for out in outs.values():
        assert torch.isfinite(out).all()
    for backend in ("jnp", "gathered"):
        torch.testing.assert_close(outs[backend], outs["paged_fused"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_static_engine_runs_on_card_by_default(dev, backend):
    """``ServeEngine`` on the card without naming it: the dense cache's
    kernels run (score-only LUT kernel on ``"jnp"``, fused decode on
    ``"paged_fused"``), the group flush encodes, and the greedy tokens
    equal those of the same run with every kernel's plain version."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg = dataclasses.replace(reduce_for_smoke(get_config("tinyllama-1.1b")),
                              decode_backend=backend)
    m = get_model(cfg)
    params = m.init(generator=_gen(dev, 15))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 50))
    mod = qkk if backend == "jnp" else pak
    before = (mod.launches, pek.launches, fpk.launches)
    eng = ServeEngine(m, params, max_len=96)
    out = eng.generate({"tokens": toks}, GenerationConfig(max_new_tokens=20))
    nl = cfg.num_layers
    # 19 decode steps; prefill encodes 1 group, position 63 flushes one
    assert (mod.launches - before[0], pek.launches - before[1],
            fpk.launches - before[2]) == (19 * nl, 2 * nl, nl)
    with mock.patch.multiple(qkk, polar_qk_scores=qkk.polar_qk_scores_plain), \
            mock.patch.multiple(
                pak, polar_decode_attention_grouped=pak.
                polar_decode_attention_grouped_plain), \
            mock.patch.multiple(pek, polar_encode=pek.polar_encode_plain), \
            mock.patch.multiple(fpk, flash_prefill=fpk.flash_prefill_plain):
        plain = eng.generate({"tokens": toks},
                             GenerationConfig(max_new_tokens=20))
    assert out["tokens"].shape == (3, 20)
    assert (out["tokens"] == plain["tokens"]).mean() >= 0.9


# ---------------------------------------------------------------------------
# uint8 values (QuantConfig.value_bits > 0): codes + one fp32 scale and
# zero per row, in every kernel that reads value rows
# ---------------------------------------------------------------------------


def _u8_values(dev, gen, shape, bits):
    """uint8 mid-tread value codes of random rows with their (…, 1) fp32
    scale and zero (``quantizers.encode_values``)."""
    from repro_torch.core import quantizers as qz
    qv = qz.encode_values(torch.randn(shape, generator=gen, device=dev), bits)
    return qv.codes, qv.scale, qv.zero


# body: "split" (d 64, the served shape) or "unsplit" (d 48: d % 32 != 0
# sends the page walk to the unsplit body)
@pytest.mark.parametrize("body", ["split", "unsplit"])
@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
@pytest.mark.parametrize("bits", [4, 8])
def test_paged_decode_kernel_u8_values_match_plain(dev, bits, case, body):
    """Kernel #2's uint8 branch against its plain version at 1e-4: codes,
    scales and zeros of the NaN-poisoned scratch page behind every dead
    table entry never reach a sum."""
    s, hkv, qh, fl, n, pp = _DECODE_CASES[case]
    d, g = (64 if body == "split" else 48), 128
    gen = _gen(dev, 20)
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    enc = ops.polar_encode(k, group_size=g)
    pool = [x.reshape(pp, hkv, *x.shape[-2:]).contiguous() for x in enc]
    vc, vs, vz = _u8_values(dev, gen, (pp, hkv, g, d), bits)
    scratch = pp - 1
    for x in (*pool[1:], vs, vz):
        x[scratch] = float("nan")
    vc[scratch] = 255
    table = torch.full((s, n + 1), scratch, dtype=torch.int32, device=dev)
    perm = torch.randperm(scratch, generator=gen, device=dev).to(torch.int32)
    used = 0
    for sl, f in enumerate(fl):
        table[sl, :f // g] = perm[used:used + f // g]
        used += f // g
    flushed = torch.tensor(fl, dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    launches = pdk.launches
    got = pdk.polar_paged_decode_grouped(q, *pool, vc, table[:, :n], flushed,
                                         vscale=vs, vzero=vz)
    assert pdk.launches == launches + 1
    ref = pdk.polar_paged_decode_grouped_plain(q, *pool, vc, table[:, :n],
                                               flushed, vscale=vs, vzero=vz)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", sorted(_DENSE_CASES))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t_bits", [4, 3])
def test_polar_attention_kernel_u8_values_match_plain(dev, bits, t_bits,
                                                      case):
    """Kernel #5's uint8 branch: ragged row lengths (0, a partial group,
    whole groups), every value scale and zero past a row's length NaN and
    every code there the largest."""
    gen = _gen(dev, 21)
    q, enc, length = _dense_case(dev, gen, case, t_bits)
    b, hkv, _, d = q.shape
    t_cap = enc[0].shape[2] * enc[0].shape[3]
    vc, vs, vz = _u8_values(dev, gen, (b, hkv, t_cap, d), bits)
    for i, n in enumerate(length.tolist()):
        vc[i, :, n:] = 255
        vs[i, :, n:] = float("nan")
        vz[i, :, n:] = float("nan")
    got = _dense_launch(case, lambda: pak.polar_decode_attention_grouped(
        q, *enc, vc, length, vscale=vs, vzero=vz, t_bits=t_bits))
    ref = pak.polar_decode_attention_grouped_plain(
        q, *enc, vc, length, vscale=vs, vzero=vz, t_bits=t_bits)
    _check_dense(got, ref, length)


@pytest.mark.parametrize("start,clen,width,d", [
    (0, 256, 6, 64), (384, 77, 4, 64), (1024, 255, 8, 64), (2048, 1, 16, 64),
    (1024, 77, 8, 32), (1024, 255, 8, 128)])
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8])
def test_paged_prefill_kernel_u8_values_match_plain(dev, start, clen, width,
                                                    d, kvdtype, bits):
    """Kernel #4's uint8 branch on both bodies at 1e-4: bf16 chunk K/V take
    the tensor-core body (codes as the bf16 B operand, P scaled by the row
    scales, sum_t p_t z_t per row), fp32 the FMA body. NaN scales and zeros
    on the scratch page and on the value page at ``start``."""
    hkv, qh, g, tc, pp = 4, 8, 128, 256, 20
    scratch = pp - 1
    gen = _gen(dev, 22)
    pool, _ = _prefill_pools(dev, gen, pp, hkv, g, d)
    vc_pool, vs, vz = _u8_values(dev, gen, (pp, hkv, g, d), bits)
    row = torch.randperm(scratch, generator=gen, device=dev)[:width].to(
        torch.int32)
    row[start // g + (clen + g - 1) // g:] = scratch
    for x in (*pool[1:], vs, vz):
        x[scratch] = float("nan")
    if start // g < width:
        vs[int(row[start // g])] = float("nan")       # dead: at/past start
        vz[int(row[start // g])] = float("nan")
    q = torch.randn((hkv, qh * tc, d), generator=gen, device=dev) * d ** -0.5
    kc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    vc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    n, n_mma = ppk.launches, ppk.launches_mma
    got = ppk.polar_paged_prefill_grouped(q, kc, vc, *pool, vc_pool, row,
                                          start, clen, vscale=vs, vzero=vz)
    assert ppk.launches == n + 1
    assert ppk.launches_mma == n_mma + int(kvdtype == torch.bfloat16)
    ref = ppk.polar_paged_prefill_grouped_plain(
        q, kc, vc, *pool, vc_pool, row, start, clen, vscale=vs, vzero=vz)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_full_decode_entries_u8_values_on_card_match_plain(dev):
    """Both ``ops`` decode entries with uint8 values (kernel partials +
    the residual rows dequantized in PyTorch), ragged lengths, against the
    same entries with the plain versions swapped in."""
    from unittest import mock
    b, hkv, qh, d, g, gc = 3, 4, 8, 64, 128, 3
    gen = _gen(dev, 23)
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    vc, vs, vz = _u8_values(dev, gen, (b, hkv, gc * g, d), 4)
    res = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((b, hkv * qh, d), generator=gen, device=dev)
    length = torch.tensor([5, 256, 383], dtype=torch.int32, device=dev)
    got = ops.polar_decode_attention_full(q, *enc, res, vc, length,
                                          vscale=vs, vzero=vz)
    with mock.patch.object(pak, "polar_decode_attention_grouped",
                           pak.polar_decode_attention_grouped_plain):
        ref = ops.polar_decode_attention_full(q, *enc, res, vc, length,
                                              vscale=vs, vzero=vz)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # the page pools: the same rows as pages 0..8 of a 10-page pool
    pool = [x.transpose(1, 2).reshape(b * gc, hkv, *x.shape[3:]).contiguous()
            for x in enc]
    vpool = [x.reshape(b, hkv, gc, g, -1).transpose(1, 2)
             .reshape(b * gc, hkv, g, x.shape[-1]).contiguous()
             for x in (vc, vs, vz)]
    table = torch.arange(b * gc, dtype=torch.int32, device=dev).reshape(b, gc)
    got = ops.polar_paged_decode_attention_full(
        q, *pool, res, vpool[0], table, length, vscale=vpool[1],
        vzero=vpool[2])
    with mock.patch.object(pdk, "polar_paged_decode_grouped",
                           pdk.polar_paged_decode_grouped_plain):
        ref_p = ops.polar_paged_decode_attention_full(
            q, *pool, res, vpool[0], table, length, vscale=vpool[1],
            vzero=vpool[2])
    torch.testing.assert_close(got, ref_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_u8_value_wrappers_reject_bad_inputs(dev):
    gen = _gen(dev, 24)
    enc = _dense_groups(dev, gen, 1, 2, 64, 16, 2)
    q = torch.randn((1, 2, 4, 64), generator=gen, device=dev)
    vc, vs, vz = _u8_values(dev, gen, (1, 2, 32, 64), 4)
    ln = torch.tensor([16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="vscale and vzero"):
        pak.polar_decode_attention_grouped(q, *enc, vc, ln)
    with pytest.raises(ValueError, match="float32"):
        pak.polar_decode_attention_grouped(q, *enc, vc, ln,
                                           vscale=vs.half(), vzero=vz)
    with pytest.raises(ValueError, match="vscale/vzero"):
        pak.polar_decode_attention_grouped(q, *enc, vc, ln,
                                           vscale=vs[:, :, :16], vzero=vz)


def test_value_quantized_engines_on_card(dev):
    """``QuantConfig(value_bits=4)`` through every engine on the card:
    classic and chunked prefix-cache paged serving launch the uint8
    branches of kernels #2 and #4 (every chunk on the tensor-core body),
    ``ServeEngine``'s fused route kernel #5; greedy tokens agree with the
    same runs on the plain versions. Pages of 64 tokens, a size the
    tensor-core body takes (the smoke config's 32 is not)."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
    )
    base = reduce_for_smoke(get_config("tinyllama-1.1b"), dtype="bfloat16")
    cfg = dataclasses.replace(base, quant=dataclasses.replace(
        base.quant, value_bits=4, group_size=64))
    m = get_model(cfg)
    params = m.init(generator=_gen(dev, 25))
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, (128,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
             for t in rng.integers(8, 40, 4)]

    def reqs():
        return [Request(rid=i, prompt=np.concatenate([shared, t]),
                        max_new_tokens=6,
                        arrival_time=0.0 if i == 0 else 1000.0)
                for i, t in enumerate(tails)]

    before = (pdk.launches, ppk.launches, ppk.launches_mma)
    out = ContinuousBatchingEngine(m, params, max_slots=2, max_len=256).run(
        reqs(), GenerationConfig())
    assert all(r.done_tokens == 6 for r in out["requests"])
    assert pdk.launches > before[0] and ppk.launches == before[1]
    chunked = ContinuousBatchingEngine(m, params, max_slots=2, max_len=256,
                                       prefill_chunk=64, prefix_cache=True)
    out_c = chunked.run(reqs(), GenerationConfig())
    n_pp = ppk.launches - before[1]
    assert n_pp > 0 and ppk.launches_mma - before[2] == n_pp
    assert out_c["adopted_pages"] > 0
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 50))
    fused = get_model(dataclasses.replace(cfg, decode_backend="paged_fused"))
    n = pak.launches
    eng = ServeEngine(fused, params, max_len=96)
    got = eng.generate({"tokens": toks}, GenerationConfig(max_new_tokens=12))
    assert pak.launches - n == 11 * cfg.num_layers
    with mock.patch.multiple(
            pak, polar_decode_attention_grouped=pak.
            polar_decode_attention_grouped_plain):
        plain = eng.generate({"tokens": toks},
                             GenerationConfig(max_new_tokens=12))
    assert (got["tokens"] == plain["tokens"]).mean() >= 0.9


# ---------------------------------------------------------------------------
# CUDA graphs of the paged engine's decode dispatch (serve/graphs.py)
# ---------------------------------------------------------------------------


def _graph_core(dev, runahead=0, seed=31, lens=(10, 40, 70, 100),
                spec=None, backend="paged_fused", arch="tinyllama-1.1b",
                **cfg_over):
    """A bf16 smoke-width EngineCore of ``arch`` on the card (4 slots of 4
    pages of 32 tokens) with one prefilled request per slot: live pages
    1-4, so each width bucket has slots it covers. ``cfg_over`` replaces
    config fields (a ``quant`` or a ``cache_policy``)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import EngineCore, GenerationConfig, Request
    cfg = reduce_for_smoke(get_config(arch), dtype="bfloat16",
                           decode_backend=backend, **cfg_over)
    m = get_model(cfg)
    params = m.init(generator=_gen(dev, seed))
    core = EngineCore(m, params, max_slots=len(lens), max_len=128,
                      runahead=runahead, spec=spec)
    core.reset(GenerationConfig())
    rng = np.random.default_rng(seed)
    for i, t in enumerate(lens):
        core.add_request(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, (t,))
            .astype(np.int32), max_new_tokens=16))
    for _ in lens:
        core.step()   # one admission + whole-prompt prefill each
    assert len(core.sched.active) == len(lens) and not core._prefilling
    return core


def _state_tensors(state, scratch=None):
    """Every buffer of every layer; ``scratch`` drops that pool page."""
    out = []
    for c in state:
        pools = [c.key_codes, *c.key_scales.values(), c.value_codes,
                 c.value_scale, c.value_zero, c.value_fp]
        for x in pools:
            if x is not None:
                out.append(x if scratch is None else
                           torch.cat([x[:scratch], x[scratch + 1:]]))
        # a token-wise codec's cache has no residual
        out += [x for x in (c.key_residual, c.lengths) if x is not None]
    return out


def _assert_states_equal(a, b, scratch=None):
    for x, y in zip(_state_tensors(a, scratch), _state_tensors(b, scratch),
                    strict=True):
        assert torch.equal(x, y)


def test_decode_graph_replay_matches_eager_step_per_width(dev):
    """Per width bucket: a replayed one-token step equals the eager
    ``decode_paged`` + sampling on a copy of the same state — logits bit
    for bit, tokens, every pool buffer. A replay with every lane inactive
    leaves the state untouched outside the scratch page."""
    _check_replay_per_width(dev, _graph_core(dev))


def test_moe_decode_graph_replay_matches_eager_step(dev):
    """The same on qwen2-moe smoke: the MoE FFN (fp32 router, stable sort,
    ``index_add_`` dispatch into a fixed-size buffer) captures, and each
    width's replayed step is bit-equal to the eager step."""
    core = _graph_core(dev, arch="qwen2-moe-a2.7b")
    assert core.model.cfg.family == "moe"
    _check_replay_per_width(dev, core)


def _check_replay_per_width(dev, core):
    import copy
    from repro_torch.serve.core import _sample
    g, s = core.layout.page_size, core.layout.slots
    scratch = core.layout.scratch_page
    for w in core._decode_widths():
        lengths = core.state[0].lengths.cpu().numpy()
        mask = lengths // g + 1 <= w
        assert mask.any()
        tok = np.random.default_rng(w).integers(
            0, core.model.cfg.vocab_size, s).astype(np.int64)
        table = core.sched.alloc.table()[:, :w]
        # capture first: its eager run writes the scratch page
        core._graphs.capture(w, 1, 0.0, 0, -1)
        ref = copy.deepcopy(core.state)
        lg, _ = core.model.decode_paged(
            core.params, ref, torch.from_numpy(tok).to(dev),
            table.to(dev), torch.from_numpy(mask).to(dev))
        want = _sample(lg, core.gen)
        logits, nxt = core._graphs.step(w, 0.0, 0, tok, table, mask)
        assert torch.equal(logits, lg)
        assert torch.equal(nxt, want)
        _assert_states_equal(core.state, ref)
        before = copy.deepcopy(core.state)
        core._graphs.step(w, 0.0, 0, tok, table, np.zeros(s, bool))
        _assert_states_equal(core.state, before, scratch)
    assert len(core._graphs) == len(core._decode_widths())


def test_decode_graph_counters_after_capture_and_replays(dev):
    """The eager run before a capture counts its launches; the capture
    itself counts none; each replay adds what the capture recorded."""
    from repro_torch.serve import graphs as G
    core = _graph_core(dev)
    nl = core.model.cfg.num_layers
    w = core._decode_widths()[-1]
    before = G.read_counters()
    cap = core._graphs.capture(w, 1, 0.0, 0, -1)
    assert cap.counts == {(pek, "launches"): nl, (pdk, "launches"): nl,
                          (pdk, "launches_split"): nl}
    after = G.read_counters()
    assert {k: after[k] - before[k] for k in before
            if after[k] != before[k]} == cap.counts
    s = core.layout.slots
    for _ in range(3):
        core._graphs.step(w, 0.0, 0, np.zeros(s, np.int64),
                          core.sched.alloc.table()[:, :w], np.ones(s, bool))
    end = G.read_counters()
    assert {k: end[k] - after[k] for k in end if end[k] != after[k]} == \
        {k: 3 * n for k, n in cap.counts.items()}


@pytest.mark.parametrize("h", [1, 4])
def test_decode_graph_replay_runs_the_counted_kernels(dev, h):
    """What a replay adds to the counters is what it launches: a profiled
    replay (every lane inactive) runs each counted wrapper's kernel
    function exactly as often as the capture recorded — nl encodes and nl
    paged decodes a micro-step, a merge after each split walk — and no
    other hand-written kernel; every paged decode on the split body, as
    its counter says."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    core = _graph_core(dev, runahead=h)
    nl, s = core.model.cfg.num_layers, core.layout.slots
    w = core._decode_widths()[-1]
    cap = core._graphs.capture(w, h, 0.0, 0, -1)
    assert cap.counts == {(pek, "launches"): nl * h,
                          (pdk, "launches"): nl * h,
                          (pdk, "launches_split"): nl * h}
    values = {"token": np.zeros(s, np.int64),
              "table": core.sched.alloc.table()[:, :w],
              "active": np.zeros(s, bool)}
    if h > 1:
        values |= {"remaining": np.zeros(s, np.int32),
                   "done": np.ones(s, bool)}
    fns = ("polar_encode_kernel", "lut_split_decode_kernel",
           "lut_flash_decode_kernel", "merge_splits_kernel",
           "flash_prefill_kernel", "flash_prefill_mma_kernel",
           "paged_prefill_kernel", "paged_prefill_mma_kernel",
           "polar_qk_kernel")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can lose a trace's first records: leading kernels
        # take that loss
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        core._graphs._replay(cap, values)
        torch.cuda.synchronize()
    ran = dict.fromkeys(fns, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for f in fns:
                if re.search(rf"\b{f}\b", e.key):
                    ran[f] += e.count
    assert ran["lut_split_decode_kernel"] == \
        cap.counts[(pdk, "launches_split")]
    body = ran.pop("lut_split_decode_kernel") + ran.pop(
        "lut_flash_decode_kernel")
    assert body == nl * h
    split = pdk.plan_splits(s, core.model.cfg.num_kv_heads, w) > 1
    want = dict.fromkeys(ran, 0) | {
        "polar_encode_kernel": nl * h,
        "merge_splits_kernel": nl * h if split else 0}
    assert ran == want


def test_decode_graphs_survive_reset(dev):
    """``reset()`` zeroes the state in place: the graphs captured in one
    session replay the next, and its streams equal a fresh engine's."""
    from repro_torch.serve import EngineCore, GenerationConfig, Request
    core = _graph_core(dev)
    m, params = core.model, core.params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, m.cfg.vocab_size, (int(t),)).astype(np.int32)
               for t in (20, 50, 90)]

    def serve(eng):
        eng.reset(GenerationConfig())
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=12))
        list(eng.events())
        return {r.rid: r.out_tokens for r in eng.result()["requests"]}

    first = serve(core)
    n = len(core._graphs)
    assert n > 0
    assert serve(core) == first
    assert len(core._graphs) == n
    fresh = EngineCore(m, params, max_slots=core.layout.slots, max_len=128)
    assert serve(fresh) == first


def test_horizon_graph_matches_four_eager_steps(dev):
    """One H=4 horizon replay against four eager one-token steps whose
    mask drops finished slots (budgets 1-4, one slot frozen by an earlier
    horizon): tokens of every live micro-step, the carries, and every
    buffer outside the scratch page."""
    import copy
    from repro_torch.serve.core import _sample
    core = _graph_core(dev, runahead=4)
    s, h = core.layout.slots, 4
    w = core._decode_widths()[-1]
    table = core.sched.alloc.table()[:, :w]
    tok0 = core._next_tok.astype(np.int64)
    rem0 = np.array([1, 4, 2, 3], np.int32)
    done0 = np.array([False, False, False, True])
    core._graphs.capture(w, h, 0.0, 0, -1)
    ref = copy.deepcopy(core.state)
    toks, tok, done, rem = core._graphs.horizon(
        w, h, 0.0, 0, -1, tok0, table, np.ones(s, bool), rem0, done0)
    live, left = ~done0, rem0.copy()
    cur = torch.from_numpy(tok0).to(dev)
    want = np.full((h, s), -1)
    for j in range(h):
        act = torch.from_numpy(live.copy()).to(dev)
        lg, _ = core.model.decode_paged(core.params, ref, cur, table.to(dev),
                                        act)
        nxt = _sample(lg, core.gen).long()
        cur = torch.where(act, nxt, cur)
        for sl in np.flatnonzero(live):
            want[j, sl] = int(nxt[sl])
            left[sl] -= 1
            live[sl] = left[sl] > 0
    got = toks.cpu().numpy()
    keep = want >= 0
    assert np.array_equal(got[keep], want[keep])
    assert torch.equal(tok, cur)
    assert done.all() and rem.cpu().tolist() == [0, 0, 0, 3]
    _assert_states_equal(core.state, ref, core.layout.scratch_page)


def test_sampled_decode_graph_matches_eager_steps(dev):
    """``temperature > 0``: the session generator registered with the
    graph draws what eager sampling draws from the same state, replay
    after replay; and a sampled engine gives one stream at H = 1 and
    H = 4 (the rewind after a horizon whose lanes froze early)."""
    import copy
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    from repro_torch.serve.core import _sample
    core = _graph_core(dev)
    gen = GenerationConfig(temperature=0.8, top_k=8, seed=7)
    s = core.layout.slots
    w = core._decode_widths()[-1]
    table = core.sched.alloc.table()[:, :w]
    core._graphs.capture(w, 1, gen.temperature, gen.top_k, -1)
    ref = copy.deepcopy(core.state)
    eager_gen = torch.Generator(device=dev)
    eager_gen.manual_seed(3)
    core._generator.manual_seed(3)
    tok = core._next_tok.astype(np.int64)
    for _ in range(3):
        mask = np.ones(s, bool)
        lg, _ = core.model.decode_paged(
            core.params, ref, torch.from_numpy(tok).to(dev), table.to(dev),
            torch.from_numpy(mask).to(dev))
        want = _sample(lg, gen, eager_gen)
        logits, nxt = core._graphs.step(w, gen.temperature, gen.top_k, tok,
                                        table, mask)
        assert torch.equal(logits, lg) and torch.equal(nxt, want)
        tok = nxt.cpu().numpy().astype(np.int64)
    assert torch.equal(core._generator.get_state(), eager_gen.get_state())
    _assert_states_equal(core.state, ref)

    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, core.model.cfg.vocab_size, (int(t),))
             .astype(np.int32), int(b)) for t, b in ((20, 17), (45, 23))]
    streams = []
    for h in (0, 4):
        eng = ContinuousBatchingEngine(core.model, core.params, max_slots=2,
                                       max_len=128, runahead=h)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=b)
                       for i, (p, b) in enumerate(reqs)], gen)
        streams.append({r.rid: r.out_tokens for r in out["requests"]})
        if h:
            assert out["runahead"]["horizons"] > 0
            assert out["decode_graphs"] >= 2
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# Speculative verify graphs (serve/graphs.py "verify" keys) and kernel #6
# at a wide span
# ---------------------------------------------------------------------------

#: the two verifiers and the decode backend that selects each
_VERIFIERS = {"span": "jnp", "scan": "paged_fused"}


def _spec_core(dev, verifier):
    from repro_torch.spec import SpecConfig
    return _graph_core(dev, spec=SpecConfig(mode="ngram", k=4),
                       backend=_VERIFIERS[verifier])


def _verify_inputs(core, w, q, seed):
    """A span per slot the width covers: the next token, then drafts
    half of which repeat an earlier eager verify's argmaxes (so some are
    accepted)."""
    import copy
    from repro_torch.spec import make_verifier
    g, s = core.layout.page_size, core.layout.slots
    lengths = core.state[0].lengths.cpu().numpy()
    mask = lengths // g + 1 <= w
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, core.model.cfg.vocab_size, (s, q))
    toks[:, 0] = core._next_tok
    dlen = rng.integers(0, q, s).astype(np.int32)
    table = core.sched.alloc.table()[:, :w]
    probe = copy.deepcopy(core.state)
    preds, _, _ = make_verifier(core.model)(
        core.params, probe, torch.from_numpy(toks).to(core.device),
        torch.from_numpy(dlen).to(core.device), table.to(core.device),
        torch.from_numpy(mask).to(core.device))
    toks[::2, 1] = preds[::2, 0].cpu().numpy()
    return toks, dlen, table, mask


@pytest.mark.parametrize("verifier", sorted(_VERIFIERS))
def test_verify_graph_replay_matches_eager(dev, verifier):
    """Per (width, span width) key: a replayed verify equals the eager
    verifier (a fresh one, with its own shadow state) on a copy of the
    same state — argmaxes, accepted counts and every buffer outside the
    scratch page; a replay with every lane inactive leaves the state
    untouched outside the scratch page."""
    import copy
    from repro_torch.spec import make_verifier
    core = _spec_core(dev, verifier)
    s, scratch = core.layout.slots, core.layout.scratch_page
    assert core._graphs.verifier.kind == verifier
    accepted = 0
    for w in core._decode_widths():
        for q in core._spec_q_buckets():
            toks, dlen, table, mask = _verify_inputs(core, w, q, w * 10 + q)
            # capture first: its eager run writes the scratch page
            core._graphs.capture_verify(w, q)
            ref = copy.deepcopy(core.state)
            want = make_verifier(core.model)(
                core.params, ref, torch.from_numpy(toks).to(dev),
                torch.from_numpy(dlen).to(dev), table.to(dev),
                torch.from_numpy(mask).to(dev))
            preds, n_acc = core._graphs.verify(w, q, toks, dlen, table,
                                               mask)
            assert torch.equal(preds, want[0]) and torch.equal(n_acc,
                                                               want[1])
            _assert_states_equal(core.state, ref, scratch)
            accepted += int(n_acc[torch.from_numpy(mask).to(dev)].sum())
            before = copy.deepcopy(core.state)
            core._graphs.verify(w, q, toks, dlen, table, np.zeros(s, bool))
            _assert_states_equal(core.state, before, scratch)
    assert accepted > 0
    assert len(core._graphs) == \
        len(core._decode_widths()) * len(core._spec_q_buckets())


@pytest.mark.parametrize("verifier", sorted(_VERIFIERS))
def test_verify_graph_replay_runs_the_counted_kernels(dev, verifier):
    """What a verify replay adds to the counters is what it launches (a
    profiled replay, every lane inactive): the scan verifier runs Q
    vanilla steps (nl encodes and nl paged decodes each) and Q masked
    commits (nl encodes each); the span verifier runs, per layer, the
    score-only LUT kernel over the pages and over the flushed group, the
    flush emulation's encode and the commit's encode."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    core = _spec_core(dev, verifier)
    nl, s = core.model.cfg.num_layers, core.layout.slots
    w, q = core._decode_widths()[-1], core._spec_q_buckets()[-1]
    cap = core._graphs.capture_verify(w, q)
    want = ({(pek, "launches"): 2 * q * nl, (pdk, "launches"): q * nl,
             (pdk, "launches_split"): q * nl}
            if verifier == "scan" else
            {(pek, "launches"): 2 * nl, (qkk, "launches"): 2 * nl})
    assert cap.counts == want
    values = {"tokens": np.zeros((s, q), np.int64),
              "draft_len": np.zeros(s, np.int32),
              "table": core.sched.alloc.table()[:, :w],
              "active": np.zeros(s, bool)}
    fns = ("polar_encode_kernel", "lut_split_decode_kernel",
           "lut_flash_decode_kernel", "merge_splits_kernel",
           "flash_prefill_kernel", "flash_prefill_mma_kernel",
           "paged_prefill_kernel", "paged_prefill_mma_kernel",
           "polar_qk_kernel")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can lose a trace's first records: leading kernels
        # take that loss
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        core._graphs._replay(cap, values)
        torch.cuda.synchronize()
    ran = dict.fromkeys(fns, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for f in fns:
                if re.search(rf"\b{f}\b", e.key):
                    ran[f] += e.count
    body = ran.pop("lut_split_decode_kernel") + ran.pop(
        "lut_flash_decode_kernel")
    assert body == want.get((pdk, "launches"), 0)
    split = pdk.plan_splits(s, core.model.cfg.num_kv_heads, w) > 1
    assert ran == dict.fromkeys(ran, 0) | {
        "polar_encode_kernel": want[(pek, "launches")],
        "polar_qk_kernel": want.get((qkk, "launches"), 0),
        "merge_splits_kernel": body if split else 0}


def test_qk_kernel_wide_span_tiles_query_heads(dev):
    """Kernel #6 at Qh = 8 * 17 (a span of k = 16 drafts folded onto
    tinyllama's 8 query heads per kv head): its shared memory would
    exceed the H100's 227 KB in one launch, so the wrapper tiles the
    query heads (100 a launch at d 64, t_bits 4); the scores equal the
    plain version's."""
    gen = _gen(dev, 12)
    b, hkv, d, g, gc, qh = 2, 4, 64, 128, 3, 8 * 17
    assert qkk.max_rows(d, 4) == 100
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev)
    n = qkk.launches
    got = qkk.polar_qk_scores(q, *enc)
    assert qkk.launches == n + 2
    ref = qkk.polar_qk_scores_plain(q, *enc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    one = qkk.polar_qk_scores(q[:, :, :8].contiguous(), *enc)
    assert torch.equal(one, got[:, :, :8])   # rows do not depend on Qh


# ---------------------------------------------------------------------------
# the fixed angle grid (#1's branch) and per-layer cache policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g,offset", [(64, 128, 0), (64, 32, 0),
                                        (128, 16, 0), (36, 32, 0),
                                        (64, 128, 1)])
@pytest.mark.parametrize("t_bits", [4, 3])
def test_encode_kernel_fixed_grid_exact(dev, dtype, d, g, offset, t_bits):
    """#1 on the fixed angle grid, dense and paged forms: codes and stats
    bit-equal to the plain version, theta_scale the float32 2pi/2^t and
    theta_zero 0; a pair at theta == 2pi (atan2(+0, x < 0) + pi) takes
    the top angle code; ``launches_fixed`` counts the launches."""
    k = _encode_keys(dev, _gen(dev, 3), (2, 3, 4 * g, d), dtype, offset)
    k[1, 1, 2, 0], k[1, 1, 2, d // 2] = -1.0, 0.0
    n, nf = pek.launches, pek.launches_fixed
    got = pek.polar_encode(k, t_bits=t_bits, group_size=g, fixed=True)
    ref = pek.polar_encode_plain(k, t_bits=t_bits, group_size=g, fixed=True)
    assert (pek.launches, pek.launches_fixed) == (n + 1, nf + 1)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    step = np.float32(2 * np.pi / (1 << t_bits))
    assert bool((got[3] == float(step)).all()) and not got[4].any()
    assert int(got[0][1, 1, 0, 2, 0]) & ((1 << t_bits) - 1) == \
        (1 << t_bits) - 1
    pages = torch.tensor([[3, -1, 0, 5], [-1, 1, 6, -1]], dtype=torch.int32,
                         device=dev)
    pools = [[torch.zeros((8, 3, g, d // 2), dtype=torch.uint8, device=dev)]
             + [torch.zeros((8, 3, 1, d // 2), device=dev) for _ in range(4)]
             for _ in range(2)]
    pek.polar_encode_pages(k, pages, *pools[0], t_bits=t_bits, fixed=True)
    pek.polar_encode_pages_plain(k, pages, *pools[1], t_bits=t_bits,
                                 fixed=True)
    for a, b in zip(*pools):
        assert torch.equal(a, b)
        assert not a[[2, 4, 7]].any()


def _fixed_pools(dev, gen, pp, hkv, d, g):
    """(PP, Hkv, ·) pools from the fixed-grid encode kernel."""
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    enc = ops.polar_encode(k, group_size=g, fixed=True)
    return [x.reshape(pp, hkv, *x.shape[-2:]).contiguous() for x in enc]


def test_decode_kernels_on_fixed_grid_stats_match_plain(dev):
    """#2 (paged decode), #5 (dense decode) and #6 (LUT scores) read
    theta_scale/theta_zero as arrays: on the fixed grid's stats each
    equals its plain version (1e-4)."""
    gen = _gen(dev, 41)
    s, hkv, qh, d, g, pp = 4, 2, 8, 64, 128, 12
    pool = _fixed_pools(dev, gen, pp, hkv, d, g)
    values = torch.randn((pp, hkv, g, d), generator=gen, device=dev)
    table = torch.stack([torch.randperm(pp - 1, generator=gen, device=dev)[:3]
                         for _ in range(s)]).to(torch.int32)
    flushed = torch.tensor([0, 128, 256, 384], dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    got = pdk.polar_paged_decode_grouped(q, *pool, values, table, flushed)
    ref = pdk.polar_paged_decode_grouped_plain(q, *pool, values, table,
                                               flushed)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # the dense forms: (B, Hkv, G, g, ·) from the first 3 pages per row
    dense = [torch.stack([x[table[i].long()] for i in range(s)]).transpose(
        1, 2).contiguous() for x in pool]
    dvals = torch.stack([values[table[i].long()] for i in range(s)]
                        ).transpose(1, 2).reshape(s, hkv, 3 * g, d)
    length = torch.tensor([0, 200, 384, 300], dtype=torch.int32, device=dev)
    got = pak.polar_decode_attention_grouped(q, *dense, dvals.contiguous(),
                                             length)
    ref = pak.polar_decode_attention_grouped_plain(q, *dense, dvals, length)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    got = qkk.polar_qk_scores(q, *dense)
    ref = qkk.polar_qk_scores_plain(q, *dense)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _policy_over(policy):
    """Config fields of the ``int8`` and ``mixed`` policies (smoke g 32)."""
    from repro_torch.core.codecs import CachePolicy
    from repro_torch.core.quantizers import QuantConfig
    polar = QuantConfig(group_size=32)
    int8 = QuantConfig(method="int", key_bits=8, group_size=32)
    if policy == "int8":
        return {"quant": int8}
    return {"quant": polar,
            "cache_policy": CachePolicy.first_k(1, int8, polar)}


@pytest.mark.parametrize("policy", ["int8", "mixed"])
def test_decode_graph_replay_matches_eager_step_under_policies(dev, policy):
    """A replayed one-token step equals the eager step on a copy of the
    state, per width, under the int8 policy (every layer on the gathered
    route) and the mixed one (layer 0 gathered, the rest on #2): logits
    bit for bit, tokens, every buffer; the capture makes no host sync on
    the gathered route."""
    import copy
    from repro_torch.serve.core import _sample
    core = _graph_core(dev, **_policy_over(policy))
    s = core.layout.slots
    nl = core.model.cfg.num_layers
    for w in core._decode_widths():
        lengths = core.state[0].lengths.cpu().numpy()
        mask = lengths // core.layout.page_size + 1 <= w
        tok = np.random.default_rng(w).integers(
            0, core.model.cfg.vocab_size, s).astype(np.int64)
        table = core.sched.alloc.table()[:, :w]
        cap = core._graphs.capture(w, 1, 0.0, 0, -1)
        npolar = 0 if policy == "int8" else nl - 1
        assert cap.counts.get((pdk, "launches"), 0) == npolar
        ref = copy.deepcopy(core.state)
        lg, _ = core.model.decode_paged(
            core.params, ref, torch.from_numpy(tok).to(dev),
            table.to(dev), torch.from_numpy(mask).to(dev))
        want = _sample(lg, core.gen)
        logits, nxt = core._graphs.step(w, 0.0, 0, tok, table, mask)
        assert torch.equal(logits, lg)
        assert torch.equal(nxt, want)
        _assert_states_equal(core.state, ref)


# ---------------------------------------------------------------------------
# the paper's widths: head_dim 128 (llama3.1-8b, granite-8b, yi-9b,
# qwen1.5-4b) and one query head per kv head (qwen1.5-4b's MHA)
# ---------------------------------------------------------------------------

# (slots, kv heads, query heads per kv head): llama3.1-8b / granite-8b,
# yi-9b and qwen1.5-4b at the serving phase's 8 slots over 8-page rows
_D128 = {"llama": (8, 8, 4), "yi": (8, 4, 8), "qwen": (8, 20, 1),
         "dbrx": (8, 8, 6)}


def _d128_values(dev, gen, shape, values):
    """Value rows of ``shape`` as fp32, bf16 or 4-bit uint8 codes; returns
    (rows, vscale, vzero), the last two None for fp rows."""
    if values == "u8":
        return _u8_values(dev, gen, shape, 4)
    dt = torch.float32 if values == "fp32" else torch.bfloat16
    return torch.randn(shape, generator=gen, device=dev).to(dt), None, None


@pytest.mark.parametrize("values", ["fp32", "bf16", "u8"])
@pytest.mark.parametrize("case", sorted(_D128))
def test_paged_decode_kernel_d128_matches_plain(dev, case, values):
    """Kernel #2 at d 128 (P 64 pairs, g 128) on the split body, slots
    flushed 0..896 over 8-page rows, dead entries on a NaN scratch page:
    1e-4 against the plain version. At 20 kv heads (qwen1.5-4b) 8 slots
    already make 160 blocks, so the planner leaves the walk unsplit."""
    s, hkv, qh = _D128[case]
    d, g, n = 128, 128, 8
    pp = s * n + 1
    scratch = pp - 1
    gen = _gen(dev, 30)
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    pool = [x.reshape(pp, hkv, *x.shape[-2:]).contiguous()
            for x in ops.polar_encode(k, group_size=g)]
    vals, vs, vz = _d128_values(dev, gen, (pp, hkv, g, d), values)
    for x in pool[1:] + [x for x in (vs, vz) if x is not None]:
        x[scratch] = float("nan")
    if values == "u8":
        vals[scratch] = 255
    else:
        vals[scratch] = float("nan")
    fl = [0, 128, 256, 384, 512, 640, 768, 896]
    table = torch.full((s, n), scratch, dtype=torch.int32, device=dev)
    perm = torch.randperm(scratch, generator=gen, device=dev).to(torch.int32)
    for sl, f in enumerate(fl):
        table[sl, :f // g] = perm[sl * n:sl * n + f // g]
    flushed = torch.tensor(fl, dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    assert pdk.plan_splits(s, hkv, n) == {"llama": 4, "yi": 8, "qwen": 1,
                                          "dbrx": 4}[case]
    n_all, n_split = pdk.launches, pdk.launches_split
    got = pdk.polar_paged_decode_grouped(q, *pool, vals, table, flushed,
                                         vscale=vs, vzero=vz)
    assert pdk.launches == n_all + 1
    assert pdk.launches_split == n_split + 1, "d 128 left the split body"
    ref = pdk.polar_paged_decode_grouped_plain(q, *pool, vals, table,
                                               flushed, vscale=vs, vzero=vz)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_paged_decode_kernel_reports_its_body(dev):
    """``launches_split`` counts the split body only: d 48 (d % 32 != 0)
    runs the unsplit one."""
    s, hkv, qh, d, g, pp = 2, 2, 4, 48, 128, 5
    gen = _gen(dev, 31)
    k = torch.randn((1, pp * hkv, g, d), generator=gen, device=dev)
    pool = [x.reshape(pp, hkv, *x.shape[-2:]).contiguous()
            for x in ops.polar_encode(k, group_size=g)]
    vals = torch.randn((pp, hkv, g, d), generator=gen, device=dev)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    flushed = torch.tensor([256, 128], dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev)
    n_all, n_split = pdk.launches, pdk.launches_split
    pdk.polar_paged_decode_grouped(q, *pool, vals, table, flushed)
    assert (pdk.launches, pdk.launches_split) == (n_all + 1, n_split)


@pytest.mark.parametrize("values", ["fp32", "bf16", "u8"])
@pytest.mark.parametrize("case", sorted(_D128))
def test_polar_attention_kernel_d128_matches_plain(dev, case, values):
    """Kernel #5 at d 128 on the split body: the static phase's 8 rows x
    9 groups at the config's kv and query heads, ragged lengths (0, a
    partial group, whole groups, the full buffer), stats and value rows
    past each length NaN-poisoned (uint8: codes at 255, scales and zeros
    NaN)."""
    _, hkv, qh = _D128[case]
    b, d, g, gc = 8, 128, 128, 9
    gen = _gen(dev, 32)
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    lens = [1024, 900, 0, 128, 1, 513, 640, 1152]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    vals, vs, vz = _d128_values(dev, gen, (b, hkv, gc * g, d), values)
    for i, n in enumerate(lens):
        for x in enc[1:]:
            x[i, :, -(-n // g):] = float("nan")
        if values == "u8":
            vals[i, :, n:] = 255
            vs[i, :, n:] = float("nan")
            vz[i, :, n:] = float("nan")
        else:
            vals[i, :, n:] = float("nan")
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    n_all, n_split = pak.launches, pak.launches_split
    got = pak.polar_decode_attention_grouped(q, *enc, vals, length,
                                             vscale=vs, vzero=vz)
    assert pak.launches == n_all + 1
    assert pak.launches_split == n_split + 1, "d 128 left the split body"
    ref = pak.polar_decode_attention_grouped_plain(q, *enc, vals, length,
                                                   vscale=vs, vzero=vz)
    _check_dense(got, ref, length)


@pytest.mark.parametrize("values", ["bf16", "u8"])
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,clen", [(1024, 256), (384, 77), (0, 255)])
def test_paged_prefill_kernel_qh1_hkv20_matches_plain(dev, start, clen,
                                                      kvdtype, values):
    """Kernel #4 at qwen1.5-4b's shape: 20 kv heads of one query head each
    (a 256-token chunk is four 64-row q tiles per kv head), d 128, over a
    fragmented prefix with the page at ``start`` and the chunk rows past
    ``chunk_len`` poisoned: 1e-4 on both bodies (bf16 chunk K/V take the
    tensor-core body)."""
    _check_paged_prefill_d128(dev, 20, 1, start, clen, kvdtype, values)


@pytest.mark.parametrize("values", ["bf16", "u8"])
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,clen", [(1024, 256), (384, 77), (0, 255)])
def test_paged_prefill_kernel_qh6_hkv8_matches_plain(dev, start, clen,
                                                     kvdtype, values):
    """Kernel #4 at dbrx-132b's shape: 8 kv heads of six query heads each
    (a 256-token chunk is 1536 q rows, 24 tiles per kv head), the same
    cases as at one query head."""
    _check_paged_prefill_d128(dev, 8, 6, start, clen, kvdtype, values)


def _check_paged_prefill_d128(dev, hkv, qh, start, clen, kvdtype, values):
    d, g, tc, pp = 128, 128, 256, 12
    scratch = pp - 1
    gen = _gen(dev, 33)
    pool, _ = _prefill_pools(dev, gen, pp, hkv, g, d)
    vals, vs, vz = _d128_values(dev, gen, (pp, hkv, g, d), values)
    width = 1 << (-(-(start + clen) // g) - 1).bit_length()
    row = torch.randperm(scratch, generator=gen, device=dev)[:width].to(
        torch.int32)
    row[-(-(start + clen) // g):] = scratch
    for x in pool[1:] + [x for x in (vs, vz) if x is not None]:
        x[scratch] = float("nan")
    if start // g < width:
        page = int(row[start // g])
        if values == "u8":
            vs[page] = float("nan")
            vz[page] = float("nan")
        else:
            vals[page] = float("nan")
    q = torch.randn((hkv, qh * tc, d), generator=gen, device=dev) * d ** -0.5
    kc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    vc = torch.randn((hkv, tc, d), generator=gen, device=dev).to(kvdtype)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    n_all, n_mma = ppk.launches, ppk.launches_mma
    got = ppk.polar_paged_prefill_grouped(q, kc, vc, *pool, vals, row,
                                          start, clen, vscale=vs, vzero=vz)
    assert ppk.launches == n_all + 1
    assert ppk.launches_mma == n_mma + int(kvdtype == torch.bfloat16)
    ref = ppk.polar_paged_prefill_grouped_plain(
        q, kc, vc, *pool, vals, row, start, clen, vscale=vs, vzero=vz)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_flash_prefill_kernel_serving_shape_d128(dev):
    """Kernel #3 at llama3.1-8b's serving prefill: 32 heads over 8 kv
    heads x 1024 tokens x d 128, bf16, causal, qwen1.5-4b's 20 / 20 heads
    and dbrx-132b's 48 / 8 (GQA ratio 6): within one bf16 step (2^-7) of
    the plain version."""
    gen = _gen(dev, 34)
    for h, hkv in ((32, 8), (20, 20), (48, 8)):
        q, k, v = (torch.randn((1, n, 1024, 128), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for n in (h, hkv, hkv))
        n = fpk.launches
        got = fpk.flash_prefill(q, k, v)
        assert fpk.launches == n + 1
        ref = fpk.flash_prefill_plain(q, k, v)
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("qh,span", [(4, 5), (1, 5), (8, 5), (4, 1),
                                     (6, 5), (6, 1)])
def test_qk_kernel_d128_span_matches_plain(dev, qh, span):
    """Kernel #6 at d 128 over 9 groups: llama3.1-8b's 4 query heads per
    kv head folded with a speculative span of 5 (20 rows), qwen1.5-4b's 1,
    dbrx-132b's 6 (30 rows) and yi-9b's 8 (40 rows) — one launch each,
    inside ``max_rows(128, 4)`` = 48 — and the plain one-token step (4 and
    6 query heads)."""
    gen = _gen(dev, 35)
    b, hkv, d, g, gc = 8, 8, 128, 128, 9
    assert qkk.max_rows(d, 4) == 48 and qh * span <= 48
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    q = torch.randn((b, hkv, qh * span, d), generator=gen, device=dev)
    n = qkk.launches
    got = qkk.polar_qk_scores(q, *enc)
    assert qkk.launches == n + 1
    ref = qkk.polar_qk_scores_plain(q, *enc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# head_dim 256 (paligemma-3b: 8 query heads over 1 kv head; recurrentgemma-
# 9b: 16 over 1) and the prefix-LM and sliding-window masks of #3
# ---------------------------------------------------------------------------

# (batch, heads, kv heads, T, d, dtype, mode, window, prefix_len, offset):
# paligemma's prefix mask (a row's prefix past T, one of 0, one ending
# mid-tile) and recurrentgemma's local window (narrower than a tile, a
# tile, wider than T, and the served 2048 over 2560 tokens), causal at
# d 256, GQA 4:1 at d 64, the FMA body (fp32, and bf16 at a 1-element
# offset); every T off the 64-row tile
@pytest.mark.parametrize("b,h,hkv,t,d,dtype,mode,window,plen,offset", [
    (2, 8, 1, 300, 256, _BF16, "prefix", 0, (100, 257), 0),
    (3, 8, 1, 130, 256, _BF16, "prefix", 0, (0, 64, 500), 0),
    (2, 8, 2, 77, 64, _BF16, "prefix", 0, (30, 70), 0),
    (2, 8, 1, 150, 256, _F32, "prefix", 0, (40, 129), 0),
    (2, 8, 1, 99, 256, _BF16, "prefix", 0, (50, 3), 1),
    (2, 16, 1, 300, 256, _BF16, "local", 37, None, 0),
    (2, 16, 1, 300, 256, _BF16, "local", 64, None, 0),
    (2, 16, 1, 200, 256, _BF16, "local", 1000, None, 0),
    (1, 16, 1, 2560, 256, _BF16, "local", 2048, None, 0),
    (2, 8, 2, 201, 64, _BF16, "local", 50, None, 0),
    (2, 16, 1, 150, 256, _F32, "local", 45, None, 0),
    (2, 16, 1, 99, 256, _BF16, "local", 20, None, 1),
    (2, 8, 1, 300, 256, _BF16, "causal", 0, None, 0),
    (2, 8, 1, 100, 256, _F32, "causal", 0, None, 0)])
def test_flash_prefill_kernel_masks_d256_match_plain(
        dev, b, h, hkv, t, d, dtype, mode, window, plen, offset):
    gen = _gen(dev, 40)

    def randn(shape):
        raw = torch.empty(int(np.prod(shape)) + offset, dtype=dtype,
                          device=dev)
        x = raw[offset:].view(shape)
        return x.copy_(torch.randn(shape, generator=gen, device=dev))

    q, k, v = randn((b, h, t, d)), randn((b, hkv, t, d)), randn((b, hkv, t, d))
    pl = None if plen is None else torch.tensor(plen, dtype=torch.int32,
                                                device=dev)
    n = fpk.launches
    got = fpk.flash_prefill(q, k, v, mode=mode, window=window, prefix_len=pl)
    assert fpk.launches == n + 1
    ref = fpk.flash_prefill_plain(q, k, v, mode=mode, window=window,
                                  prefix_len=pl)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_flash_prefill_masks_reject_bad_inputs(dev):
    q = torch.zeros((2, 8, 16, 256), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 1, 16, 256), dtype=torch.bfloat16, device=dev)
    pl = torch.tensor([4, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="prefix_len"):
        fpk.flash_prefill(q, k, k, mode="prefix")
    with pytest.raises(ValueError, match="prefix_len"):
        fpk.flash_prefill(q, k, k, prefix_len=pl)
    with pytest.raises(ValueError, match="int32"):
        fpk.flash_prefill(q, k, k, mode="prefix", prefix_len=pl.long())
    with pytest.raises(ValueError, match="window"):
        fpk.flash_prefill(q, k, k, mode="local")
    with pytest.raises(ValueError, match="mask mode"):
        fpk.flash_prefill(q, k, k, mode="sliding")
    with pytest.raises(ValueError, match="head_dim"):
        fpk.flash_prefill(q[..., :192].contiguous(),
                          *(k[..., :192].contiguous(),) * 2)


@pytest.mark.parametrize("values", ["fp32", "bf16", "u8"])
def test_polar_attention_kernel_d256_qh8_matches_plain(dev, values):
    """Kernel #5 at paligemma-3b's 8 query heads over 1 kv head, d 256
    (P 128), g 128, on the split body: two staging buffers do not fit the
    227 KB a block may opt into with bf16 rows (258,176 B), so those run
    on one (172,160 B); uint8 rows keep two; fp32 rows do not fit even
    one (237,696 B) and fail at launch. 8 rows x 9 groups, ragged lengths,
    stats and value rows past each length NaN-poisoned."""
    b, hkv, qh, d, g, gc = 8, 1, 8, 256, 128, 9
    gen = _gen(dev, 41)
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    lens = [1024, 900, 0, 128, 1, 513, 640, 1152]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    vals, vs, vz = _d128_values(dev, gen, (b, hkv, gc * g, d), values)
    for i, n in enumerate(lens):
        for x in enc[1:]:
            x[i, :, -(-n // g):] = float("nan")
        if values == "u8":
            vals[i, :, n:] = 255
            vs[i, :, n:] = float("nan")
            vz[i, :, n:] = float("nan")
        else:
            vals[i, :, n:] = float("nan")
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    n_all, n_split = pak.launches, pak.launches_split
    if values == "fp32":
        with pytest.raises(RuntimeError, match="polar_attention"):
            pak.polar_decode_attention_grouped(q, *enc, vals, length)
        assert pak.launches == n_all
        return
    got = pak.polar_decode_attention_grouped(q, *enc, vals, length,
                                             vscale=vs, vzero=vz)
    assert pak.launches == n_all + 1
    assert pak.launches_split == n_split + 1, "d 256 left the split body"
    ref = pak.polar_decode_attention_grouped_plain(q, *enc, vals, length,
                                                   vscale=vs, vzero=vz)
    _check_dense(got, ref, length)


@pytest.mark.parametrize("qh", [8, 16])
def test_qk_kernel_d256_matches_plain(dev, qh):
    """Kernel #6 at d 256 over a 2048-slot ring (16 groups of 128):
    paligemma-3b's 8 and recurrentgemma-9b's 16 query heads over one kv
    head, one launch each (``max_rows(256, 4)`` = 24), on the generic
    path (the vector path stops at d 128)."""
    b, hkv, d, g, gc = 8, 1, 256, 128, 16
    gen = _gen(dev, 42)
    assert qkk.max_rows(d, 4) == 24
    enc = _dense_groups(dev, gen, b, hkv, d, g, gc)
    q = torch.randn((b, hkv, qh, d), generator=gen, device=dev)
    n = qkk.launches
    got = qkk.polar_qk_scores(q, *enc)
    assert qkk.launches == n + 1
    ref = qkk.polar_qk_scores_plain(q, *enc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# head_dim 64 at seamless-m4t-medium's 16 kv heads of one query head: #3 in
# ``full`` mode over the encoder's frames and as cross-attention (Tq != Tk)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk,dtype", [
    (1024, 1024, _BF16), (16, 1024, _BF16), (33, 1000, _BF16),
    (33, 1000, _F32), (1, 77, _BF16), (70, 16, _BF16)])
def test_flash_prefill_full_mode_cross_shapes_match_plain(dev, tq, tk,
                                                          dtype):
    """Kernel #3 in ``full`` mode at 16 heads over 16 kv heads, d 64: the
    encoder's 1024 x 1024, the decoder prompt's 16 queries over 1024
    memory frames, a ragged 33 x 1000 on both bodies (key tiles masked
    past Tk, zero-filled q rows past Tq), a single query and more
    queries than keys; each launch counts on ``launches_full``."""
    gen = _gen(dev, 50)
    q = torch.randn((2, 16, tq, 64), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, 16, tk, 64), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    n, nf = fpk.launches, fpk.launches_full
    got = fpk.flash_prefill(q, k, v, mode="full")
    assert (fpk.launches, fpk.launches_full) == (n + 1, nf + 1)
    ref = fpk.flash_prefill_plain(q, k, v, mode="full")
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    if tq == tk:
        fpk.flash_prefill(q, k, v, mode="causal")   # not a full launch
        assert fpk.launches == n + 2
    assert fpk.launches_full == nf + 1


def _mesh_cache(dev, hkv=8, d=128, slots=8, g=128, n=8, seed=41):
    """A polar paged cache on the card (bf16 values) filled by chunked
    prefills of random keys over a permuted table: slot lengths 0 ... n*g,
    ragged, the open groups in the residual. Returns (cache, table)."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.core.quantizers import QuantConfig
    gen = _gen(dev, seed)
    lay = PagedLayout(page_size=g, num_pages=slots * n, slots=slots,
                      pages_per_slot=n)
    cache = pgc.init_paged_cache(QuantConfig(group_size=g), lay, hkv, d,
                                 dtype=torch.bfloat16, device=dev)
    perm = torch.randperm(lay.num_pages, generator=gen, device=dev)
    table = perm.reshape(slots, n).to(torch.int32)
    for sl in range(slots):
        tl = (sl * 131 + 77) % (n * g - 1) + 1
        tp = -(-tl // g) * g
        k, v = (torch.randn((1, hkv, tp, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        pgc.paged_prefill(cache, sl, table[sl], k, v, tl)
    return cache, table


def _rank_view(n: int, r: int):
    from repro_torch.launch.mesh import Mesh
    return Mesh({"data": 1, "model": n}, {"data": 0, "model": r},
                {"data": [r], "model": list(range(n))})


def test_sharded_dispatch_at_world_one_is_bit_equal(dev, tmp_path):
    """An NCCL world of one: the head-sharded decode (#2) and chunk
    prefill (#4) — one head block, the gather an NCCL all-reduce — equal
    the unsharded calls bit for bit, and launch the kernels."""
    import torch.distributed as dist
    from repro_torch.core import paged_cache as pgc
    from repro_torch.distributed import serving as dsrv
    from repro_torch.launch.mesh import init_world, make_mesh
    cache, table = _mesh_cache(dev)
    gen = _gen(dev, 42)
    q = torch.randn((8, 32, 128), generator=gen, device=dev).to(torch.bfloat16)
    qc = torch.randn((1, 32, 256, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((1, 8, 256, 128), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    row, start, clen = table[3, :4], 256, 200
    init_world(0, 1, f"file://{tmp_path / 'rdzv'}", "nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        shard = dsrv.shard_paged_state(cache, mesh)
        n_dec, n_pre = pdk.launches, ppk.launches
        got = dsrv.sharded_paged_decode_attention(shard, q, table, mesh=mesh)
        got_pre = dsrv.sharded_paged_prefill_attention(
            shard, qc, kc, vc, row, start, clen, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert pdk.launches == n_dec + 1 and ppk.launches == n_pre + 1
    assert torch.equal(got, pgc.paged_decode_attention(cache, q, table))
    assert torch.equal(got_pre, pgc.paged_prefill_attention(
        cache, qc, kc, vc, row, start, clen))


def test_head_block_decode_plans_globally_and_is_bit_equal(dev):
    """#2 on one of two head blocks (4 of 8 kv heads, 8 slots x 8 pages):
    its own heads would plan 8 splits, the model's plan 4; with the
    global plan every block's output is bit-equal to the same heads of
    the whole call, through the kernel and through the cache's dispatch."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.distributed import serving as dsrv
    assert pdk.plan_splits(8, 8, 8) == 4 and pdk.plan_splits(8, 4, 8) == 8
    cache, table = _mesh_cache(dev)
    gen = _gen(dev, 43)
    q = torch.randn((8, 32, 128), generator=gen, device=dev).to(torch.bfloat16)
    whole = pgc.paged_decode_attention(cache, q, table)
    sc = cache.key_scales
    stats = [sc[k] for k in ("rho_scale", "rho_zero", "theta_scale",
                             "theta_zero")]
    q4 = (q.float() * 128 ** -0.5).reshape(8, 8, 4, 128)
    flushed = (cache.lengths // 128) * 128
    parts = pdk.polar_paged_decode_grouped(q4, cache.key_codes, *stats,
                                           cache.value_fp, table, flushed)
    for r in range(2):
        shard = dsrv.shard_paged_state(cache, _rank_view(2, r))
        blk = slice(4 * r, 4 * r + 4)
        got = pgc.paged_decode_attention(shard, q[:, 16 * r:16 * r + 16],
                                         table)
        assert torch.equal(got, whole[:, 16 * r:16 * r + 16])
        sstats = [x[:, blk].contiguous() for x in stats]
        sparts = pdk.polar_paged_decode_grouped(
            q4[:, blk].contiguous(), shard.key_codes, *sstats,
            shard.value_fp, table, flushed, plan_heads=8)
        assert all(torch.equal(a[:, blk], b) for a, b in zip(parts, sparts))


def test_dense_head_block_decode_plans_globally_and_is_bit_equal(dev):
    """The static engine's linear caches under a head split: #5 on one of
    two head blocks (4 of 8 kv heads, 8 rows x 9 groups of 128, d 128)
    plans its splits for the model's 8 kv heads (nsplit 3, where its own
    4 would plan 5), and the dense cache's fused and score routes on each
    block (``KVCache.head_shard``; the score route's einsums at the
    model's head count, ``kv_cache.head_einsum``) are bit-equal to the
    same heads of the whole call."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.quantizers import QuantConfig
    assert pdk.plan_splits(8, 8, 9) == 3 and pdk.plan_splits(8, 4, 9) == 5
    gen = _gen(dev, 47)
    qc = QuantConfig(group_size=128)
    k = torch.randn((8, 8, 1000, 128), generator=gen, device=dev).to(_BF16)
    v = torch.randn((8, 8, 1000, 128), generator=gen, device=dev).to(_BF16)
    q = torch.randn((8, 32, 128), generator=gen, device=dev).to(_BF16)
    whole = kvc.init_cache(qc, 8, 8, 128, 1152, device=dev)
    kvc.prefill(whole, k, v)
    want = {"fused": kvc.fused_decode_attention(whole, q),
            "score": kvc.decode_attention(whole, q)}
    for r in range(2):
        blk = slice(4 * r, 4 * r + 4)
        shard = kvc.init_cache(qc, 8, 8, 128, 1152, device=dev,
                               head_shard=(r, 2))
        kvc.prefill(shard, k[:, blk].contiguous(), v[:, blk].contiguous())
        qb = q[:, 16 * r:16 * r + 16].contiguous()
        n = pak.launches_split
        got = {"fused": kvc.fused_decode_attention(shard, qb),
               "score": kvc.decode_attention(shard, qb)}
        assert pak.launches_split == n + 1
        for route, out in got.items():
            assert torch.equal(out, want[route][:, 16 * r:16 * r + 16]), \
                (route, r)


def test_head_einsum_runs_a_shard_at_the_model_shape(dev):
    """On the card a batched einsum at a head block's batch count may sum
    in another order than the whole call's; ``head_einsum`` at the
    model's head count gives the block the whole call's bits."""
    from repro_torch.core.kv_cache import head_einsum
    gen = _gen(dev, 53)
    p = torch.softmax(torch.randn((8, 8, 4, 1152), generator=gen,
                                  device=dev), -1)
    vals = torch.randn((8, 8, 1152, 128), generator=gen, device=dev)
    whole = torch.einsum("bhqt,bhtd->bhqd", p, vals)
    for r in range(2):
        blk = slice(4 * r, 4 * r + 4)
        got = head_einsum("bhqt,bhtd->bhqd", p[:, blk].contiguous(),
                          vals[:, blk].contiguous(), 8)
        assert torch.equal(got, whole[:, blk])


# (B, H, Hkv, Tq, Tk, d, mode, window, dtype): the training path's #3
# forward with the log-sum-exp — tinyllama's 8:1 GQA, every mask mode, a
# ragged T, both bodies (bf16 tensor cores, fp32 FMA) and d 32 / 64 / 128
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,mode,window,dtype", [
    (2, 8, 1, 200, 200, 64, "causal", 0, _BF16),
    (2, 8, 2, 130, 130, 64, "causal", 0, _F32),
    (2, 8, 2, 150, 150, 64, "prefix", 0, _BF16),
    (2, 8, 2, 150, 150, 32, "local", 40, _F32),
    (2, 8, 2, 150, 150, 128, "local", 40, _BF16),
    (2, 4, 4, 70, 200, 64, "full", 0, _BF16),
    (2, 4, 4, 70, 200, 32, "full", 0, _F32)])
def test_flash_prefill_lse_matches_plain(dev, b, h, hkv, tq, tk, d, mode,
                                         window, dtype):
    gen = _gen(dev, 5)
    q = torch.randn((b, h, tq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, hkv, tk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    pl = (torch.tensor([37, 120], dtype=torch.int32, device=dev)
          if mode == "prefix" else None)
    kw = dict(mode=mode, window=window, prefix_len=pl)
    n, nl = fpk.launches, fpk.launches_lse
    out, lse = fpk.flash_prefill(q, k, v, return_lse=True, **kw)
    assert (fpk.launches, fpk.launches_lse) == (n + 1, nl + 1)
    ref, ref_lse = fpk.flash_prefill_plain(q, k, v, return_lse=True, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    assert torch.equal(out, fpk.flash_prefill(q, k, v, **kw))


@pytest.mark.parametrize("dtype,tol", [(_F32, 1e-3), (_BF16, 2e-2)])
@pytest.mark.parametrize("mode,tq,tk,window", [
    ("causal", 130, 130, 0), ("prefix", 130, 130, 0), ("local", 130, 130, 40),
    ("full", 70, 150, 0)])
def test_flash_attention_grads_on_card(dev, dtype, tol, mode, tq, tk,
                                       window):
    """dq / dk / dv of the differentiable attention (the kernel's forward,
    the ported backward) against autograd through the reference attention
    in fp32: relative L2 within 1e-3 (fp32) and 2e-2 (bf16)."""
    from repro_torch.core.attention import flash_attention, \
        reference_attention
    gen = _gen(dev, 6)
    q = torch.randn((2, 8, tq, 64), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, 2, tk, 64), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    g = torch.randn((2, 8, tq, 64), generator=gen, device=dev)
    pl = (torch.tensor([50, 9], dtype=torch.int32, device=dev)
          if mode == "prefix" else None)
    kw = dict(mode=mode, window=window, prefix_len=pl)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = fpk.launches_lse
    got = torch.autograd.grad(flash_attention(*xs, **kw), xs, g.to(dtype))
    assert fpk.launches_lse == n + 1
    rs = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(reference_attention(*rs, **kw), rs, g)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        rel = torch.linalg.vector_norm(a.float() - w) / \
            torch.linalg.vector_norm(w)
        assert float(rel) <= tol, (mode, float(rel))


def test_train_step_on_card_by_default(dev):
    """The smoke tinyllama's train step on the card (the default device):
    every #3 launch writes the log-sum-exp, two a layer under block
    remat, and the loss matches the CPU's plain run within 1e-4."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import get_model
    from repro_torch.train import StepConfig, init_train_state, \
        make_train_step
    from repro_torch.train.train_step import (train_state_from_jax,
                                              train_state_to_jax)
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    model = get_model(cfg)
    state = init_train_state(model, 0)
    assert state.params["embed"].is_cuda
    batch = SyntheticLMDataset(cfg, 4, 64).next_batch()
    step = make_train_step(model, None, StepConfig())
    n = fpk.launches_lse
    _, m = step(state, batch)
    assert fpk.launches_lse == n + 2 * cfg.num_layers
    cpu = train_state_from_jax(train_state_to_jax(state, cfg), cfg,
                               device="cpu")
    _, mc = step(cpu, batch)
    assert abs(float(m["loss"]) - float(mc["loss"])) <= 1e-4 * float(
        mc["loss"])
