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
from repro_torch.kernels import polar_encode as pek  # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g", [(64, 128), (32, 16), (128, 32)])
def test_encode_kernel_codes_exact(dev, dtype, d, g):
    k = torch.randn((2, 3, 4 * g, d), generator=_gen(dev), device=dev).to(
        dtype)
    k[0, 0, :3, :2] = 0.0
    n = pek.launches
    got = pek.polar_encode(k, group_size=g)
    ref = pek.polar_encode_plain(k, group_size=g)
    assert pek.launches == n + 1
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)


def test_encode_pages_kernel_skips_negative_pages(dev):
    g, d, h, pp = 128, 64, 4, 10
    k = torch.randn((3, h, g, d), generator=_gen(dev, 1), device=dev).to(
        torch.bfloat16)
    pages = torch.tensor([[2], [-1], [7]], dtype=torch.int32, device=dev)

    def pools():
        return [torch.zeros((pp, h, g, d // 2), dtype=torch.uint8,
                            device=dev)] + \
            [torch.zeros((pp, h, 1, d // 2), device=dev) for _ in range(4)]

    a, b = pools(), pools()
    pek.polar_encode_pages(k, pages, *a)
    pek.polar_encode_pages_plain(k, pages, *b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not a[0][[0, 1, 3, 4, 5, 6, 8, 9]].any()


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(dev, vdtype):
    s, hkv, qh, d, g, pp, n = 4, 2, 8, 64, 128, 12, 3
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
    table[1, :1] = torch.tensor([5])
    table[2, :3] = torch.tensor([8, 0, 3])
    table[3, :2] = torch.tensor([1, 9])
    flushed = torch.tensor([0, 128, 384, 256], dtype=torch.int32, device=dev)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    sliced = table[:, :n]                 # a non-contiguous width slice
    got = pdk.polar_paged_decode_grouped(q, *pool, values, sliced, flushed)
    ref = pdk.polar_paged_decode_grouped_plain(q, *pool, values, sliced,
                                               flushed)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,d,dtype", [(200, 64, torch.float32),
                                       (64, 32, torch.float32),
                                       (130, 128, torch.bfloat16)])
def test_flash_prefill_kernel_matches_plain(dev, t, d, dtype):
    gen = _gen(dev, 3)
    q = torch.randn((2, 8, t, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, 2, t, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, 2, t, d), generator=gen, device=dev).to(dtype)
    got = fpk.flash_prefill(q, k, v)
    ref = fpk.flash_prefill_plain(q, k, v)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


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
