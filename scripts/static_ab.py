#!/usr/bin/env python3
"""Time the port's static engine from several checkouts in one call, on one
card, and what the head-padded cache einsums cost a mesh rank.

    python3 scripts/static_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (an unpacked
``git archive`` of another commit, for instance); each runs in a process
of its own, with that checkout's package and CUDA sources, in the order
given, and prints one JSON line:

* ``static``: the meshless ``ServeEngine`` at the static shape of
  ``chip_smoke.py`` (tinyllama-1.1b at full width and 6 layers, random
  seeded weights; 8 rows x 1000-token prompts, 64 greedy new tokens,
  max_len 1152) on the fused route (#5, ``"paged_fused"``) and the score
  route (#6, ``"jnp"``): the host-clock prefill and decode seconds of each
  of 3 runs after a warm-up;
* ``head_einsum`` (a checkout that has ``kv_cache.head_einsum``): the #6
  route's ``decode_attention`` of one layer over a rank's block of
  llama3.1-8b's KV heads on two ranks (8 rows x 4 of 8 kv heads x 4
  query heads, 1000 of 1152 tokens, d 128, polar keys, bf16 values) —
  mean device ms (CUDA events, 50 calls after a warm-up, L2 flushed
  before each) with the einsums run at the model's 8 heads (zero-padded,
  as served) and at the rank's 4, beside the whole 8-head call, and the
  bytes of the padded operands a call allocates.

The card's name and power limit are printed first. Needs one CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

DEPTH, SB, SPROMPT, SNEW, SMAX = 6, 8, 1000, 64, 1152


def _time_ms(torch, fn, flush, iters=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(5_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _static(torch, dev) -> dict:
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, ServeEngine
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=DEPTH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = get_model(cfg).init(generator=gen, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SB, SPROMPT)), device=dev).long()
    out = {}
    for backend in ("paged_fused", "jnp"):
        model = get_model(dataclasses.replace(cfg, decode_backend=backend))
        eng = ServeEngine(model, params, max_len=SMAX, device=dev)
        eng.generate({"tokens": prompts}, GenerationConfig(max_new_tokens=2))
        runs = [eng.generate({"tokens": prompts},
                             GenerationConfig(max_new_tokens=SNEW))
                for _ in range(3)]
        out[backend] = {"prefill_s": [r["prefill_s"] for r in runs],
                        "decode_s": [r["decode_s"] for r in runs]}
    return out


def _head_einsum(torch, dev, flush) -> dict | None:
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.core import kv_cache as kvc
    if not hasattr(kvc, "head_einsum"):
        return None
    qc = get_config("llama3.1-8b").quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, hkv, qh, d, t = SB, 8, 4, 128, SPROMPT

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    k = randn(b, hkv, t, d).to(torch.bfloat16)
    v = randn(b, hkv, t, d).to(torch.bfloat16)
    q = randn(b, hkv * qh, d).to(torch.bfloat16)
    whole = kvc.prefill(kvc.init_cache(qc, b, hkv, d, SMAX, device=dev),
                        k, v)
    shard = kvc.prefill(kvc.init_cache(qc, b, hkv, d, SMAX, device=dev,
                                       head_shard=(0, 2)),
                        k[:, :hkv // 2].contiguous(),
                        v[:, :hkv // 2].contiguous())
    q_shard = q[:, :hkv * qh // 2].contiguous()
    padded = kvc.decode_attention(shard, q_shard)
    ref = kvc.decode_attention(whole, q)[:, :hkv * qh // 2]
    torch.cuda.synchronize()
    out = {"padded_equal_whole": bool(torch.equal(padded, ref)),
           "padded_ms": _time_ms(
               torch, lambda: kvc.decode_attention(shard, q_shard), flush),
           "whole_ms": _time_ms(
               torch, lambda: kvc.decode_attention(whole, q), flush)}
    with mock.patch.object(kvc, "head_einsum",
                           lambda eq, x, y, heads: torch.einsum(eq, x, y)):
        own = kvc.decode_attention(shard, q_shard)
        torch.cuda.synchronize()
        out["own_equal_whole"] = bool(torch.equal(own, ref))
        out["own_ms"] = _time_ms(
            torch, lambda: kvc.decode_attention(shard, q_shard), flush)
    # the padded operands of the two einsums: probs (B, H, Qh, T) and the
    # dequantized values (B, H, T, d), the residual's q (B, H, Qh, d) and
    # keys (B, H, g, d), all fp32, at the model's H
    g = shard.key_residual.shape[2]
    out["padded_operand_bytes"] = 4 * b * hkv * (qh * SMAX + SMAX * d
                                                 + qh * d + g * d)
    return out


def run_one(root: str) -> dict:
    import torch
    sys.path.insert(0, f"{root}/src")
    from repro_torch.kernels import _build
    _build.build(("polar_encode", "flash_prefill", "polar_attention",
                  "polar_qk"))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t0 = time.monotonic()
    static = _static(torch, dev)
    return {"root": root, "static": static,
            "head_einsum": _head_einsum(torch, dev, flush),
            "seconds": time.monotonic() - t0}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
