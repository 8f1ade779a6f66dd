#!/usr/bin/env python3
"""Time the port's flash prefill (#3, causal), dense fused decode (#5) and
paged decode (#2) kernels from several checkouts in one call, on one card.

    python3 scripts/kernel_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (an unpacked
``git archive`` of another commit, for instance); each runs in a process
of its own, with that checkout's wrappers and CUDA sources, in the order
given, and prints one JSON line: the mean device ms of each kernel (CUDA
events, 50 launches after a warm-up, L2 flushed before each) at the
shapes the serving phases of ``chip_smoke.py`` run them — flash prefill
at 1 x 32 / 4 heads x 1024 tokens (d 64), 8 x 32 / 4 x 1000 (d 64) and
1 x 32 / 8 x 1024 (d 128), bf16; #5 over 8 rows x 8 of 9 groups at 4 kv
x 8 query heads (d 64) and 8 x 4 (d 128); #2 over 8 slots x 8 pages at
the same heads. Inputs come from a seeded generator on the card, the same
in every checkout. Needs one CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys


def _time_ms(torch, fn, flush, iters=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def run_one(root: str) -> dict:
    """Build and time the three kernels of the checkout at ``root``."""
    import torch
    sys.path.insert(0, f"{root}/src")
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    _build.build(("flash_prefill", "polar_attention", "paged_decode",
                  "polar_encode"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {}
    for b, h, hkv, t, d in ((1, 32, 4, 1024, 64), (8, 32, 4, 1000, 64),
                            (1, 32, 8, 1024, 128)):
        q = randn(b, h, t, d).bfloat16()
        k, v = randn(b, hkv, t, d).bfloat16(), randn(b, hkv, t, d).bfloat16()
        out[f"flash_prefill[{b}x{h}/{hkv}x{t},d{d}]"] = _time_ms(
            torch, lambda: fpk.flash_prefill(q, k, v), flush)
    for hkv, qh, d in ((4, 8, 64), (8, 4, 128)):
        enc = pe.polar_encode(randn(8, hkv, 8 * 128, d).bfloat16())
        bufs = [torch.zeros((8, hkv, 9, *x.shape[3:]), dtype=x.dtype,
                            device=dev) for x in enc]
        for buf, x in zip(bufs, enc):
            buf[:, :, :8] = x
        vals = randn(8, hkv, 9 * 128, d).bfloat16()
        q = randn(8, hkv, qh, d)
        length = torch.full((8,), 8 * 128, dtype=torch.int32, device=dev)
        out[f"polar_attention[8x{hkv}x{qh},d{d}]"] = _time_ms(
            torch, lambda: pak.polar_decode_attention_grouped(
                q, *bufs, vals, length), flush)
        pool = [x.reshape(65, hkv, *x.shape[-2:]).contiguous() for x in
                pe.polar_encode(randn(1, 65 * hkv, 128, d))]
        pvals = randn(65, hkv, 128, d).bfloat16()
        table = torch.randperm(64, generator=gen, device=dev).reshape(
            8, 8).to(torch.int32)
        out[f"paged_decode[8x{hkv}x{qh},d{d}]"] = _time_ms(
            torch, lambda: pd.polar_paged_decode_grouped(
                q, *pool, pvals, table, length), flush)
    return {"checkout": root, "ms": {k: round(v, 5) for k, v in out.items()}}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
