#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line:

1. env      — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions, the float32 matmul settings.
2. build    — compiles the three hand-written kernels (one ``nvcc`` per
              source, in parallel) from ``src/repro_torch/kernels/csrc``.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving path's shapes (encode codes exactly equal,
              attention within the stated tolerances, a NaN-poisoned
              scratch page), then times kernel, plain version and — for
              flash prefill — the PyTorch library call.
4. model    — full-width tinyllama-1.1b in bf16 (random weights from a
              seeded generator): a 512-token prefill and 16 teacher-forced
              decode steps through the kernels and through the plain
              versions; per-step relative logit error.
5. serve    — ``ContinuousBatchingEngine`` at full width: 8 slots,
              max_len 1024, 16 greedy requests (prompts 100-900 tokens,
              64 new tokens, staggered arrivals). Launch counters are set
              to 0 just before and read just after; every kernel must have
              run the expected number of times.
6. profile  — wall time of 8-slot decode steps against the device time of
              their kernels (torch.profiler): the device's idle share and
              the largest kernels.

Then one JSON line of per-kernel numbers, and last the device JSON. Any
failure raises (non-zero exit). Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor bf16; fp32 non-tensor
FP32_TOL = 1e-4               # rtol = atol, as the JAX kernel tests
BF16_RTOL = 2 ** -7           # one bf16 rounding step of the output
# bf16 model, kernel path vs plain path: both round to bf16 at the same
# points but sum in other orders, so single bf16 ulps (2^-8) differ; over
# 22 layers of random weights such differences grow (1.5e-2 at prefill,
# before any quantized key is read, on an H100 80GB HBM3 at 700 W), and
# decode adds rare polar-code flips downstream of them
MODEL_REL_L2 = 5e-2
PLAIN_LEAD = 20_000_000       # ~10 ms of spin: plain versions enqueue many ops

# serving-path shapes of full-width tinyllama-1.1b with the default cache
HKV, QH, D, G = 4, 8, 64, 128
P = D // 2


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_ms(torch, fn, iters=30, flush=None, lead_cycles=2_000_000) -> float:
    """Mean device time of one ``fn`` launch (CUDA events, after warm-up),
    L2 flushed before each launch when ``flush`` (a >50 MB buffer) is
    given. Before each launch the stream spins ``lead_cycles`` clock
    cycles (``torch.cuda._sleep``) so the host enqueues flush, events and
    launch ahead of the device: the events then bracket device time, not
    the host's enqueue latency. ``lead_cycles`` must outlast the host
    time of one ``fn`` call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(lead_cycles)
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; float32 matmul and "
          "cuDNN TF32 off", flush=True)
    return {"smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    res = _build.build()
    regs = {}
    for name, r in res.items():
        regs[name] = [ln.split("Used ")[1].strip() for ln in
                      r["log"].splitlines() if "Used " in ln]
    print(f"build: {time.monotonic() - t0:.1f} s for {sorted(res)}; ptxas "
          f"{json.dumps(regs)}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_encode(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import polar_encode as pe
    pp = 65
    # prefill form: one 1024-token prompt, 8 pages, fragmented order
    k = torch.randn((1, HKV, 1024, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k[0, 0, :5, :3] = 0.0           # zero pairs: the theta pin
    k[0, 1, 7, 4] = 1e-39           # denormal: the flush
    pages = torch.tensor([[9, 3, 40, 0, 63, 17, 5, 28]], dtype=torch.int32,
                         device=dev)

    def pools():
        return (torch.zeros((pp, HKV, G, P), dtype=torch.uint8, device=dev),
                *(torch.zeros((pp, HKV, 1, P), device=dev) for _ in range(4)))

    pk, pp_ = pools(), pools()
    pe.polar_encode_pages(k, pages, *pk)
    pe.polar_encode_pages_plain(k, pages, *pp_)
    # decode form: every slot's residual, only flushing slots write
    res = torch.randn((8, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    fpages = torch.tensor([[11], [-1], [12], [-1], [-1], [13], [-1], [64]],
                          dtype=torch.int32, device=dev)
    pe.polar_encode_pages(res, fpages, *pk)
    pe.polar_encode_pages_plain(res, fpages, *pp_)
    # dense form (ops.polar_encode)
    dk = pe.polar_encode(k)
    dp = pe.polar_encode_plain(k)
    torch.cuda.synchronize()
    code_err = max(int((pk[0].int() - pp_[0].int()).abs().max()),
                   int((dk[0].int() - dp[0].int()).abs().max()))
    stat_err = max(float((a - b).abs().max()) for a, b in
                   zip(pk[1:] + dk[1:], pp_[1:] + dp[1:]))
    assert code_err == 0, f"encode codes differ from the plain version "\
        f"(max step {code_err})"
    assert stat_err == 0.0, f"encode stats differ ({stat_err})"
    untouched = [i for i in range(pp) if i not in
                 {9, 3, 40, 0, 63, 17, 5, 28, 11, 12, 13, 64}]
    assert int(pk[0][untouched].abs().sum()) == 0, "skipped pages written"

    ms = time_ms(torch, lambda: pe.polar_encode_pages(k, pages, *pk),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: pe.polar_encode_pages_plain(
        k, pages, *pp_), iters=10, flush=flush,
                        lead_cycles=PLAIN_LEAD)
    nbytes = k.numel() * 2 + pages.numel() * 4 + 1024 * HKV * P \
        + 4 * 8 * HKV * P * 4
    flops = 22 * 1024 * HKV * P      # ~22 fp32 ops per pair (see PERF.md)
    b_ms, by = bound(nbytes, flops, "fp32")
    return {"name": "polar_encode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/polar_encode.cu",
            "replaces": "src/repro/kernels/polar_encode.py:51",
            "max_abs_err": float(max(code_err, stat_err)), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "shape": "prefill form, 1 x 4 kv heads x 1024 tokens x 64 bf16"}


def check_decode(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    s, n, pp = 8, 8, 65
    scratch = pp - 1
    codes = torch.randint(0, 256, (pp, HKV, G, P), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)

    def stat(lo, hi):
        return lo + (hi - lo) * torch.rand((pp, HKV, 1, P), generator=gen,
                                           device=dev)

    rs, rz = stat(0.01, 0.3), stat(0.0, 1.0)
    ts, tz = stat(0.05, 0.4), stat(0.0, 0.5)
    vals = torch.randn((pp, HKV, G, D), generator=gen, device=dev)
    q = torch.randn((s, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    perm = torch.randperm(scratch, generator=gen, device=dev)[:s * n]
    table = perm.reshape(s, n).to(torch.int32)
    flushed = torch.tensor([0, 128, 256, 384, 512, 640, 768, 896],
                           dtype=torch.int32, device=dev)
    # unassigned entries point at the scratch page, poisoned with NaN
    for sl in range(s):
        table[sl, int(flushed[sl]) // G:] = scratch
    for x in (rs, rz, ts, tz, vals):
        x[scratch] = float("nan")
    errs = []
    for vdt in (torch.float32, torch.bfloat16):
        v = vals.to(vdt)
        got = pd.polar_paged_decode_grouped(q, codes, rs, rz, ts, tz, v,
                                            table, flushed)
        ref = pd.polar_paged_decode_grouped_plain(q, codes, rs, rz, ts, tz,
                                                  v, table, flushed)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all(), "NaN leaked from the scratch page"
        # compare the normalized outputs and the softmax stats
        live = ref[2] > 0
        o_k = got[0] / torch.where(live, got[2], 1.0)[..., None]
        o_r = ref[0] / torch.where(live, ref[2], 1.0)[..., None]
        torch.testing.assert_close(o_k, o_r, rtol=FP32_TOL, atol=FP32_TOL)
        torch.testing.assert_close(got[1], ref[1], rtol=FP32_TOL,
                                   atol=FP32_TOL)
        torch.testing.assert_close(got[2], ref[2], rtol=FP32_TOL,
                                   atol=FP32_TOL)
        errs.append(float((o_k - o_r).abs().max()))
    # end to end through ops (residual merge) on a width-sliced table
    res = torch.randn((s, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    lengths = flushed + torch.tensor([5, 0, 127, 64, 1, 30, 100, 9],
                                     dtype=torch.int32, device=dev)
    for sl in range(s):   # the page being filled must be a real page
        table[sl, int(flushed[sl]) // G] = int(perm[sl * n]) if \
            int(flushed[sl]) == 0 else table[sl, 0]
    qf = torch.randn((s, HKV * QH, D), generator=gen, device=dev)
    vb = vals.to(torch.bfloat16)
    full_k = ops.polar_paged_decode_attention_full(
        qf, codes, rs, rz, ts, tz, res, vb, table[:, :8], lengths)
    with mock.patch.object(pd, "polar_paged_decode_grouped",
                           pd.polar_paged_decode_grouped_plain):
        full_p = ops.polar_paged_decode_attention_full(
            qf, codes, rs, rz, ts, tz, res, vb, table[:, :8], lengths)
    torch.testing.assert_close(full_k, full_p, rtol=FP32_TOL, atol=FP32_TOL)
    errs.append(float((full_k - full_p).abs().max()))

    # timing: every slot at 8 live pages (1024 tokens), bf16 values
    table_t = perm.reshape(s, n).to(torch.int32)
    fl_t = torch.full((s,), n * G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(
        q, codes, rs, rz, ts, tz, vb, table_t, fl_t), flush=flush)
    plain_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped_plain(
        q, codes, rs, rz, ts, tz, vb, table_t, fl_t), iters=10, flush=flush,
        lead_cycles=PLAIN_LEAD)
    pages = s * n * HKV
    nbytes = q.numel() * 4 + pages * (G * P + 4 * P * 4 + G * D * 2) \
        + table_t.numel() * 4 + s * 4 + s * HKV * QH * (D + 2) * 4
    # per (page, kv head): LUT 3*Qh*P*2^t, scores 4*Qh*g*P, softmax
    # ~4*Qh*g, p@V 2*Qh*g*d
    flops = pages * (3 * QH * P * 16 + 4 * QH * G * P + 4 * QH * G
                     + 2 * QH * G * D)
    b_ms, by = bound(nbytes, flops, "fp32")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:104",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": "8 slots x 4 kv heads x 8 query heads x 8 live pages"}


def check_prefill(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import flash_prefill as fpk
    h = 32
    errs = []
    for t, dt in ((1000, torch.float32), (333, torch.float32),
                  (1024, torch.bfloat16)):
        q = torch.randn((1, h, t, D), generator=gen, device=dev).to(dt)
        k = torch.randn((1, HKV, t, D), generator=gen, device=dev).to(dt)
        v = torch.randn((1, HKV, t, D), generator=gen, device=dev).to(dt)
        got = fpk.flash_prefill(q, k, v)
        ref = fpk.flash_prefill_plain(q, k, v)
        torch.cuda.synchronize()
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
        else:
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=BF16_RTOL, atol=BF16_RTOL)
        errs.append(float((got.float() - ref.float()).abs().max()))
    t = 1024
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v), flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(q, k, v),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only: the port never calls it
    ke = k.repeat_interleave(h // HKV, dim=1)
    ve = v.repeat_interleave(h // HKV, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q, ke, ve, is_causal=True),
                     flush=flush)
    nbytes = (2 * h + 2 * HKV) * t * D * 2
    flops = 4.0 * h * D * (t * (t + 1) / 2)
    b_ms, by = bound(nbytes, flops, "bf16")
    return {"name": "flash_prefill", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_prefill.py:77",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "shape": "1 x 32 heads (4 kv) x 1024 tokens x 64 bf16, causal"}


def phase_kernels(torch) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = [check_encode(torch, dev, gen, flush),
            check_decode(torch, dev, gen, flush),
            check_prefill(torch, dev, gen, flush)]
    print("kernels: " + "; ".join(
        f"{r['name']} err {r['max_abs_err']:.3g} {r['ms']:.4f} ms "
        f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"{r['bound_by']}" + (f", library {r['library_ms']:.4f} ms"
                              if r["library_ms"] is not None else "") + ")"
        for r in rows), flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernel path vs plain path
# ---------------------------------------------------------------------------


def plain_kernels():
    """Swap the three kernel wrappers for their plain versions (the
    reference run of the model phase)."""
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import polar_encode as pe
    stack = mock.patch.multiple
    return (stack(pe, polar_encode_pages=pe.polar_encode_pages_plain),
            stack(pd, polar_paged_decode_grouped=
                  pd.polar_paged_decode_grouped_plain),
            stack(fpk, flash_prefill=fpk.flash_prefill_plain))


def phase_model(torch, model, params) -> None:
    from repro_torch.core.cache_layout import PagedLayout
    dev = torch.device("cuda")
    cfg = model.cfg
    rng = torch.Generator(device="cpu")
    rng.manual_seed(1)
    t0, steps = 512, 16
    toks = torch.randint(0, cfg.vocab_size, (t0 + steps,), generator=rng)
    layout = PagedLayout(page_size=G, num_pages=8, slots=1, pages_per_slot=8)
    table = torch.arange(8, dtype=torch.int32, device=dev)[None]

    def run():
        state = model.init_paged_state(layout, dev)
        out = []
        lg, _ = model.prefill_paged(params, toks[None, :t0].to(dev), state,
                                    0, table[0], t0)
        out.append(lg.float())
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        for i in range(steps):
            lg, _ = model.decode_paged(params, state,
                                       toks[t0 + i:t0 + i + 1].to(dev),
                                       table, active)
            out.append(lg.float())
        return torch.stack(out)

    kern = run()
    a, b, c = plain_kernels()
    with a, b, c:
        plain = run()
    rel = ((kern - plain).norm(dim=-1) / plain.norm(dim=-1)).flatten()
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    assert torch.isfinite(kern).all()
    assert float(rel.max()) <= MODEL_REL_L2, f"logits drift {rel.tolist()}"
    print(f"model: tinyllama-1.1b bf16 22 layers, prefill {t0} + {steps} "
          f"teacher-forced decode steps; relative L2 logit error kernel vs "
          f"plain per step max {float(rel.max()):.3e} (prefill "
          f"{float(rel[0]):.3e}, limit {MODEL_REL_L2}); argmax agreement "
          f"{agree:.3f}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: continuous-batching serving at full width
# ---------------------------------------------------------------------------


def check_events(events, reqs) -> None:
    """Per request: admit, first_token (ordinal 0), tokens with ordinals
    1.., finish — in that order, nothing after finish."""
    by_rid: dict = {}
    for e in events:
        by_rid.setdefault(e.rid, []).append(e)
    assert sorted(by_rid) == sorted(r.rid for r in reqs)
    for r in reqs:
        evs = by_rid[r.rid]
        kinds = [e.kind for e in evs]
        assert kinds[0] == "admit" and kinds[1] == "first_token" \
            and kinds[-1] == "finish", kinds[:3]
        toks = [e for e in evs if e.kind in ("first_token", "token")]
        assert [e.ordinal for e in toks] == list(range(len(toks)))
        assert [e.token for e in toks] == r.out_tokens
        ts = [e.t for e in evs]
        assert ts == sorted(ts)


def phase_serve(torch, model, params, counters) -> dict:
    import numpy as np
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = model.cfg
    rng = np.random.default_rng(0)
    n_req, new = 16, 64
    lens = rng.integers(100, 901, n_req)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(t),))
                    .astype(np.int32), max_new_tokens=new,
                    arrival_time=0.02 * i) for i, t in enumerate(lens)]
    eng = ContinuousBatchingEngine(model, params, max_slots=8, max_len=1024)
    eng.warmup([int(t) for t in lens])
    torch.cuda.synchronize()
    for mod in counters:
        mod.launches = 0
    out = eng.run(reqs, GenerationConfig())
    torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches
                for mod in counters}
    done = out["requests"]
    assert len(done) == n_req and all(r.done_tokens == new for r in done)
    check_events(out["events"], done)
    nl, steps, pre = cfg.num_layers, out["decode_steps"], out["prefills"]
    # a prefill encodes only when the prompt fills at least one group;
    # every decode step launches the (masked) flush encode
    full = sum(int(t) >= G for t in lens)
    expect = {"polar_encode": nl * (full + steps),
              "paged_decode": nl * steps, "flash_prefill": nl * pre}
    assert launches == expect, (launches, expect)
    assert pre == n_req
    print(f"serve: {n_req} requests x {new} tokens, 8 slots, max_len 1024, "
          f"{out['total_tokens']} tokens in {out['wall_s']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{out['p50_ttft_s'] * 1e3:.1f} ms p99 "
          f"{out['p99_ttft_s'] * 1e3:.1f} ms; decode {steps} steps "
          f"mean {out['decode_step_s_mean'] * 1e3:.2f} ms p50 "
          f"{out['decode_step_s_p50'] * 1e3:.2f} ms; {pre} prefills "
          f"{out['prefill_s_total']:.3f} s; mean active slots "
          f"{out['mean_active_slots']:.2f}; launches {json.dumps(launches)}",
          flush=True)
    return launches


def phase_profile(torch, model, params) -> None:
    """Where a full-batch decode step's time goes: wall time of 8-slot
    decode steps (host clock around steps that end in the token fetch)
    against the device time of the kernels they launch (torch.profiler),
    and the largest kernels. Runs after the serve phase; its launches are
    not part of the main path's counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cache_layout import PagedLayout
    dev = torch.device("cuda")
    s, t0, n = 8, 512, 5
    layout = PagedLayout(page_size=G, num_pages=s * 8, slots=s,
                         pages_per_slot=8)
    state = model.init_paged_state(layout, dev)
    table = torch.arange(s * 8, dtype=torch.int32, device=dev).reshape(s, 8)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2)
    toks = torch.randint(0, model.cfg.vocab_size, (s, t0 + 2 * n + 2),
                         generator=gen).to(dev)
    for sl in range(s):
        model.prefill_paged(params, toks[sl:sl + 1, :t0], state, sl,
                            table[sl], t0)
    active = torch.ones((s,), dtype=torch.bool, device=dev)

    def step(i):
        lg, _ = model.decode_paged(params, state, toks[:, t0 + i], table,
                                   active)
        return lg.argmax(-1).cpu()

    step(0)
    torch.cuda.synchronize()
    w0 = time.monotonic()
    for i in range(1, n + 1):
        step(i)
    wall = (time.monotonic() - w0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n + 1, 2 * n + 1):
            step(i)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3 / n
    if busy <= 0.0:
        print(f"profile: 8-slot decode step wall {wall * 1e3:.2f} ms; "
              "device time not measured (the profiler saw no kernels)",
              flush=True)
        return
    top = sorted(kern, key=lambda e: -e.device_time_total)[:6]
    tops = ", ".join(f"{e.key[:40]} {e.device_time_total / 1e3 / n:.3f} ms"
                     for e in top)
    print(f"profile: 8-slot decode step at {t0} tokens: wall "
          f"{wall * 1e3:.2f} ms, device busy {busy:.3f} ms "
          f"(idle {1 - busy / (wall * 1e3):.1%}); per step: {tops}",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.models import get_model

    phase_env(torch)
    phase_build()
    rows = phase_kernels(torch)

    cfg = get_config("tinyllama-1.1b")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(generator=gen, device="cuda")
    phase_model(torch, model, params)
    launches = phase_serve(torch, model, params, (pe, pd, fpk))
    phase_profile(torch, model, params)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
