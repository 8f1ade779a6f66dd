"""The split page walk of the paged decode kernel, on the CPU: the host's
split planner (``kernels/paged_decode.py::plan_splits`` / ``split_ranges``)
and the plain-PyTorch model of split-then-merge — per-split plain partials
merged by ``ops.merge_softmax_partials`` — against the unsplit plain
version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402


# (slots, kv heads, table width, splits): the serving shape (8 slots x 4 kv
# heads x 8 pages -> 256 blocks), the long-context shape (1 slot x 32
# pages), the prefix phase's 16-page rows (2 pages a split), a tiny test
# shape, a batch wide enough to fill the card unsplit, one where the
# first estimate of pages per split would overshoot the target, an empty
# table; the dense decode kernel's walks over G groups: the static
# serving shape (8 rows x 4 kv heads x 9 groups -> 5 splits, 160 blocks),
# one row of 9 groups (a split a group), 66 rows (264 blocks unsplit)
@pytest.mark.parametrize("s,hkv,n,nsplit", [
    (8, 4, 8, 8), (1, 4, 32, 32), (8, 4, 16, 8), (4, 2, 3, 3),
    (64, 4, 16, 1), (25, 4, 5, 2), (8, 4, 0, 1), (1, 1, 1, 1),
    (8, 4, 9, 5), (1, 4, 9, 9), (66, 4, 3, 1)])
def test_plan_splits(s, hkv, n, nsplit):
    got = pdk.plan_splits(s, hkv, n)
    assert got == nsplit
    if got > 1:   # more blocks than one per (slot, kv head), within target
        assert s * hkv < pdk.SPLIT_TARGET_BLOCKS
        assert s * hkv * got <= pdk.SPLIT_TARGET_BLOCKS


@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 9, 16, 31, 32])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 4, 8, 32])
def test_split_ranges_cover_each_entry_once(n, nsplit):
    ranges = pdk.split_ranges(n, nsplit)
    assert len(ranges) <= max(nsplit, 1)
    covered = [i for lo, hi in ranges for i in range(lo, hi)]
    assert covered == list(range(n))
    assert all(lo < hi for lo, hi in ranges) or n == 0


def _pools(rng, pp, hkv, g, d):
    codes = torch.from_numpy(rng.integers(0, 256, (pp, hkv, g, d // 2))
                             .astype(np.uint8))

    def stat(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (pp, hkv, 1, d // 2))
                                .astype(np.float32))

    stats = [stat(0.01, 0.3), stat(0.0, 1.0), stat(0.05, 0.4), stat(0.0, 0.5)]
    values = torch.from_numpy(rng.standard_normal((pp, hkv, g, d))
                              .astype(np.float32))
    return codes, stats, values


@pytest.mark.parametrize("nsplit", [2, 3, 5])
def test_split_then_merge_matches_unsplit_plain(nsplit):
    """Each split runs the plain version over its table-entry range, with
    ``flushed`` cut to that range (0 where the range holds no live page:
    m = -1e30, l = 0); the exact merge equals the unsplit plain version's
    normalized output within 1e-5. Dead entries point at a NaN scratch
    page, and one slot has nothing flushed."""
    rng = np.random.default_rng(11)
    s, hkv, qh, d, g, pp, n = 4, 2, 4, 32, 16, 12, 5
    codes, stats, values = _pools(rng, pp, hkv, g, d)
    scratch = pp - 1
    for x in (*stats, values):
        x[scratch] = float("nan")
    flushed = torch.tensor([0, 16, 48, 80], dtype=torch.int32)
    table = torch.full((s, n + 2), scratch, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(scratch).astype(np.int32))
    used = 0
    for sl in range(s):
        live = int(flushed[sl]) // g
        table[sl, :live] = perm[used:used + live]
        used += live
    sliced = table[:, :n]                       # a width slice, as served
    q = torch.from_numpy(rng.standard_normal((s, hkv, qh, d))
                         .astype(np.float32)) * d ** -0.5

    acc, m, l = pdk.polar_paged_decode_grouped_plain(
        q, codes, *stats, values, sliced, flushed)
    ref = acc / torch.where(l == 0, 1.0, l)[..., None]

    parts = []
    for lo, hi in pdk.split_ranges(n, nsplit):
        fl = torch.clamp(flushed - lo * g, 0, (hi - lo) * g)
        parts.append(pdk.polar_paged_decode_grouped_plain(
            q, codes, *stats, values, sliced[:, lo:hi].contiguous(), fl))
    got = ops.merge_softmax_partials(parts)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # the merged softmax stats too: max of the m's, rescaled sum of the l's
    m_tot = torch.stack([p[1] for p in parts]).amax(0)
    l_tot = sum(p[2] * torch.exp(p[1] - m_tot) for p in parts)
    torch.testing.assert_close(m_tot, m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l_tot, l, rtol=1e-5, atol=1e-5)
