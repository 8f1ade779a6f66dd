#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line (the serve, runahead and prefix phases one per
run):

1. env      — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions, the float32 matmul settings.
2. build    — compiles the six hand-written kernels (one ``nvcc`` per
              source, in parallel) from ``src/repro_torch/kernels/csrc``,
              prints ptxas' registers and spills, and checks the SASS for
              the designs' instructions (``cuobjdump``: tensor-core HMMA,
              LDGSTS copies and LDSM fragment loads in flash prefill and
              paged prefill, LDGSTS copies in paged decode and the dense
              decode kernel's split body, 16-byte loads and stores in the
              score-only LUT kernel, the cluster barrier and distributed
              shared memory loads in encode).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving paths' shapes (encode codes exactly equal,
              attention and scores within the stated tolerances,
              NaN-poisoned scratch pages and dead rows), then times kernel,
              plain version and — for every kernel but encode — a PyTorch
              library call; encode in its prefill form and its decode form
              (8 slots' residual groups, none and one flushing, on a line
              of its own), flash prefill also at the static
              phase's 8 x 1000-token shape, paged decode at 1 slot x 32
              pages and paged prefill at start 2048, each on a line of its
              own; the uint8-value forms of paged decode, paged prefill
              (both bodies) and dense decode at value_bits 4 and 8, each
              timed on a row of its own (``name[u8]``); every kernel at
              the paper's widths, head_dim 128 at llama3.1-8b's 8 kv heads
              x 4 query heads (rows ``name[d128]``; #2 and #5 on the split
              body), #1-#4 at a mesh rank's 4 kv heads x 4 query heads
              (``name[d128,mesh2]``; #2 planned for the model's 8 kv heads
              and bit-equal to those heads of the whole call), #2-#6 also
              at qwen1.5-4b's 20 kv heads of one query
              head (``name[d128,qh1]``) and at dbrx-132b's 8 kv heads x 6
              query heads (``name[d128,qh6]``); head_dim 256 at one kv
              head (``[d256…]``): encode, flash prefill in its
              ``prefix`` (paligemma-3b, 8 heads, 1000 tokens, prefix 256)
              and ``local`` (recurrentgemma-9b, 16 heads, 2560 tokens,
              window 2048) modes beside SDPA with the same boolean mask,
              #5 at 8 query heads (the split body on one staging buffer)
              and #6 at 8 and 16; head_dim 64 at seamless-m4t-medium's
              16 kv heads of one query head (``[d64…]``): encode at the
              cross-cache fill, flash prefill in ``full`` mode over the
              encoder's 1024 x 1024 frames and the cross-attention's 16
              queries x 1024 frames (also a ragged 33 x 1000) and causal
              over the 16-token decoder prompt, beside SDPA, #5 at the
              self decode and #6 at the cross decode; then the paged
              engine's three decode backends against each other on one
              fragmented cache, with bf16 and with 4-bit values.
4. model    — full-width tinyllama-1.1b in bf16 (random weights from a
              seeded generator): a 512-token prefill and 16 teacher-forced
              decode steps through the kernels and through the plain
              versions; per-step relative logit error.
5. serve    — ``ContinuousBatchingEngine`` at full width: 8 slots,
              max_len 1024, 16 greedy requests (prompts 100-900 tokens,
              64 new tokens, staggered arrivals), its decode steps
              replayed CUDA graphs (one per table width, captured in the
              warmup); then the same workload with the graph cache patched
              out (every step issued eagerly): each request's tokens and
              events must be identical. Launch counters are set to 0 just
              before each run and read just after; every kernel must have
              run the expected number of times (the graphed run's counts
              are the phase's).
   graphs   — per width bucket, a replayed step against the eager step
              on a copy of the same state (8 slots prefilled to 1-8
              pages): logits bit-equal, tokens, every buffer; an
              all-inactive replay writes only the scratch page.
   From runahead to profile, tinyllama-1.1b keeps its full width and the
   first ``LATER_DEPTH`` (6) of its 22 layers; the model, serve and
   graphs phases run all 22.
   runahead — run-ahead decode (DESIGN.md §18): 8 greedy requests, 128
              new tokens, all at t = 0, at ``runahead`` 0, 4 and 8 —
              identical streams and per-request events, horizons > 0,
              exact launch counts — and a sampled case (temperature 0.8,
              top_k 8, seed 7, staggered budgets) identical at H 1 and 4;
              tok/s, per-token step, sync wait and dispatch gap per H.
   spec     — speculative decode (DESIGN.md §15): first, per verifier
              (span on ``"jnp"``, scan on ``"paged_fused"``), each span
              width's verify graph against a fresh eager verifier on a
              copy of 8 prefilled slots (argmaxes, accepted counts, every
              buffer bit-equal; inactive replays write only the scratch
              page), a profiled replay of each graph, and the device ms
              of each verify replay against the one-token step's; #6 at
              the span shape (Qh = 8 Q). Then 8 greedy requests (prompts
              100-900, 128 new, all at t = 0), ``SpecConfig(k=4)``: plain
              and ngram arms on both backends, the span arm again eager,
              a scripted oracle (acceptance 1) and adversary (acceptance
              0), and a derived 2-layer draft model on 2 requests: every
              spec arm's streams and per-request events equal its plain
              arm's, no proposer fault, exact launches per arm.
6. prefix   — chunked prefill with the shared-prefix page cache at full
              width: 8 slots, max_len 2048, 256-token chunks, 12 greedy
              requests sharing one 1024-token system prompt, served with
              and without the prefix cache. The greedy streams must be
              identical, 11 x 8 pages adopted, no COW split, every
              kernel launched the number of times the workload implies,
              and every paged prefill launch on the tensor-core body.
7. static   — the static-batching ``ServeEngine`` over dense caches at
              full width: 8 rows, 1000-token prompts, 64 greedy tokens,
              max_len 1152, on the score-only route (polar ``"jnp"``), the
              fused route (polar ``"paged_fused"``) and the fp ``"none"``
              cache; exact launch counts, the logits of each polar run
              within rel. L2 5e-2 of its plain path, cache bytes per layer
              and their polar / fp ratio, and the two polar routes' greedy
              agreement (reported, not gated).
8. values   — ``QuantConfig(value_bits=4)`` at full width on the same
              weights: a logit gate (chunked prefill + decode, kernels vs
              plain versions, rel. L2 5e-2), classic paged serving (8
              requests), chunked prefill with the prefix cache (6
              requests, every uint8 paged prefill launch on the
              tensor-core body), ``ServeEngine`` on the fused and the
              score-only routes (gated, cache bytes per layer); every
              uint8 kernel form must have run.
9. codecs   — the baseline key codecs and per-layer policies on the same
              weights, 7 arms: int8, int4, KIVI 4-bit, ZipCache 4-bit, the
              fp ``"none"`` cache, polar on the fixed angle grid and
              ``CachePolicy.first_k(2, int8, polar)``. Per arm 8 greedy
              requests (prompts 100-900, 64 new, all at t = 0) through
              the classic paged engine on ``"paged_fused"`` (codecs
              without the page-native kernels take the gathered route),
              exact launches from the arm's polar layers, exact cache
              bytes per layer, tok/s, decode step, prefill seconds and
              logical key bits; graphed == eager for int8 and the mixed
              policy; the logit gate for the mixed policy and the fixed
              grid; chunked prefill with and without the prefix cache
              (6 requests) for int8 and the mixed policy; the static
              engine on both polar routes and speculative decode (ngram
              k 4, both verifiers) under the mixed policy.
10. qos     — DESIGN.md §16 on the same weights, graphed decode, 24 greedy
              requests (prompts 100-900, 32 new) at t = 0: QoS with three
              weighted tenants (one starting with an empty token bucket),
              ``max_pending`` 16, a 1 s TTFT deadline, degradation and
              ``runahead=4`` (one terminal event per request, the pool
              drained whole, no horizon, exact launches; shed / reject /
              degrade counts and goodput under the deadline printed);
              then ngram speculation under an empty chaos schedule (the
              events of ``chaos=None``) and under
              ``exhaust@8,slow@5:0.05,cancel@12:0.5,proposer@0.3``
              (survivors' streams those of the plain graphed engine,
              quarantine released, allocator invariants, every proposer
              fault an injected one).
11. profile — wall time of 8-slot decode steps against the device time of
              their kernels (torch.profiler), eager and as a graph replay,
              and of one H = 8 horizon replay per token: the device's idle
              share and the largest kernels.
    mesh    — head-sharded paged serving on ``torch.distributed``
              (DESIGN.md §17): an NCCL world of one in this process,
              ``EngineCore(mesh=(1, 1))`` on the same model (one-shot, and
              chunked + prefix cache) with the head gather inside the
              replayed graphs — streams, events and every decode step's
              logits bit-equal to the meshless engine's; llama3.1-8b at
              full width (8 of 32 layers) over two gloo ranks spawned from
              here (``--mesh-rank``; 4 KV heads a rank, decode eager by a
              choice made before capture) — streams and events equal to
              the meshless engine's, decode logits bit-equal, each rank's
              pool bytes exactly half, its launches those of the meshless
              run; the smoke tinyllama over four gloo ranks — 2 KV heads do
              not divide 4, so every rank holds the whole pools (the GQA
              fallback, asserted). Its seconds go to stderr.
12. configs — the paper's dense configs at head_dim 128, one at a time at
              full width in bf16 (llama3.1-8b with 8 of its 32 layers,
              granite-8b, yi-9b, qwen1.5-4b whole; seeded random weights,
              qwen1.5's q/k/v biases non-zero): the paged logit gate (rel. L2 5e-2) and a graphed
              8-request serving run with exact launches each; for
              llama3.1-8b also the ``serve`` workload graphed and eager,
              ``ServeEngine`` on both polar routes (gates, exact cache
              bytes per layer) and chunked prefill with and without the
              prefix cache; for qwen1.5-4b (one query head per kv head)
              the chunked prefill; each config's peak memory.
13. moe     — the MoE family in bf16, one config at a time (seeded random
              weights): qwen2-moe-a2.7b at full width (24 layers, 60
              experts of 1408 top-4 + 4 shared units, 16 / 16 heads,
              q/k/v biases non-zero) and dbrx-132b at its published
              widths with its depth cut from 40 layers to 4 (16 experts
              of 10752 top-4, 48 / 8 heads). Each: the paged logit gate
              (rel. L2 5e-2; the plain run replays the kernel run's expert
              choices, and a plain run with its own routing reports the
              share of routing decisions that differ and holds its median
              step to 5e-2), a graphed 8-request serving run with exact
              launches, ``ServeEngine`` on both polar routes and chunked
              prefill with and without the prefix cache (3 requests);
              qwen2-moe-a2.7b also the serving run eager (each request's
              tokens and events equal) and the ``graphs`` checks. Each
              config's peak memory and the phase's seconds. Both phases
              run one loop (``phase_configs``) over a table of configs and
              arms (``D128_CONFIGS``, ``MOE_CONFIGS``).
14. families — the static-only families at head_dim 256, whole and at
              full width in bf16 (seeded random weights), one at a time:
              paligemma-3b (18 layers, 8 query heads over 1 kv head, 256
              stubbed image tokens under the prefix-LM mask) through
              ``ServeEngine`` on both polar routes — 8 rows x (256 image
              + 744 text tokens), 64 greedy tokens, exact launches, every
              fused launch on #5's split body, the logit gate over the
              prefill and all 63 decode steps —, and recurrentgemma-9b
              (38 layers: 12 (rec, rec, attn) periods + 2 rec; 16 query
              heads over 1, 2048-slot ring caches) on 8 x 2560-token
              prompts (the ring wraps at prefill, 16 new tokens) and 8 x
              2016 (it wraps in decode, 64 new): exact launches (#6 on
              every ring decode, never #5), the logit gate over the
              prefill and every decode step, tok/s, the decode step, the
              ring's bytes per attention layer and peak memory;
              seamless-m4t-medium (12 encoder + 12 decoder layers, 16 /
              16 heads at head_dim 64) through ``ServeEngine`` on both
              polar routes — 8 rows x 1024 stubbed audio frames + a
              16-token prompt, 128 greedy tokens, max_len 256 (the self
              cache flushes once in decode): exact launches (#3 ``full``
              and causal counted apart), the logit gate over the prefill
              and all 127 decode steps, the self + cross cache bytes
              exactly —; and mamba2-2.7b (64 SSD layers, no KV cache, no
              kernel) on 8 x 1000-token prompts, 64 greedy tokens: no
              launch, the decode state's bytes exactly, and the duality
              gate (prefill T + 16 steps against prefill T + 16) in fp32
              and in bf16.
15. train   — the training path: #3 with its log-sum-exp output at
              tinyllama-1.1b's training shape (8 x 32 / 4 heads x 512 x
              d 64, causal, bf16; ``out`` within 2^-7 of the plain
              version and bit-equal to the launch without ``lse``, ``lse``
              within 1e-3; timed beside the plain version and SDPA: the
              ``flash_prefill[lse]`` row); ``flash_attention``'s dq / dk
              / dv (the kernel's forward, the ported backward) against
              autograd through ``reference_attention`` in the causal,
              prefix, local and full (Tq != Tk) modes (rel. L2 1e-3 fp32,
              2e-2 bf16); then tinyllama-1.1b whole at full width through
              ``make_train_step`` (fp32 masters, bf16 compute, 8 x 512,
              block remat, 40 steps on the synthetic stream): the loss
              falls by more than 0.05 (mean of the first 5 steps to the
              last 5), the first step within 1e-3 (loss) and 2e-2
              (grad_norm) of a plain run's, exactly 2 x 22 #3 launches a
              step, step ms, tokens/s, peak memory and the share of a
              step in the ported flash backward (CUDA events); the five
              other families at smoke width (fp32, 40 steps: the loss
              falls, step 1 within 1e-4 of plain); and
              ``python -m repro_torch.launch.train --smoke --steps 12``
              in a subprocess, its checkpoint resumed here to step 16.

Each phase's end and seconds go to stderr as it ends; then a line of
seconds per phase, one JSON line of per-kernel numbers (launches summed
over the serving phases and the train phase; the uint8 forms on rows of
their own, encode's decode form — a decode step's flush — and its
fixed-angle-grid form on rows of their own, the head_dim-128 forms on
theirs, counted in the configs and moe phases, the head_dim-256 and
head_dim-64 forms on theirs, counted in the families phase, #3's
training form with the log-sum-exp on ``flash_prefill[lse]``, counted in
the train phase), and last the device JSON. Any failure raises
(non-zero exit). Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.

``python3 chip_smoke.py --variants`` runs only the env phase and then
times the alternatives the redesigned kernels were chosen against
(``VARIANTS``: flash prefill's register cap and exponential, the score-only
LUT kernel's groups per block, paged decode's pages per split and staging
buffers, paged prefill's key groups, the dense decode kernel's unsplit
body, encode's cluster of 1 or 2 blocks), each checked against the current
source, and the timing floor (a 1-element ``add_`` timed as the kernels
are).
"""
from __future__ import annotations

import contextlib
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
TC = 256                      # prefill chunk of the prefix phase
# the static phase: 8 rows, 1000-token prompts, 64 new tokens, a 1152-token
# dense buffer (9 groups); the kernel checks run at its decode shapes with
# 8 flushed groups
SB, SPROMPT, SNEW, SMAX = 8, 1000, 64, 1152
SG = SMAX // G
# tinyllama-1.1b's layers kept for the paths after ``graphs`` (runahead,
# spec, prefix, static, values, codecs, qos, profile): at full depth the
# whole run took 513 s on an H100 80GB HBM3 at 700 W, too close to its
# time limit on a slower host
LATER_DEPTH = 6


def bound(nbytes: float, flops: float | dict, kind: str = "fp32"
          ) -> tuple[float, str]:
    """Least time (ms) of moving ``nbytes`` once and doing ``flops`` at the
    ``kind`` peak — or ``flops`` = {kind: operations}, each kind on its own
    units, which may run side by side — and which of the two bounds it."""
    ops = flops if isinstance(flops, dict) else {kind: flops}
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = max(n / PEAK_FLOPS[k] * 1e3 for k, n in ops.items())
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


# SASS opcodes that show a kernel's design: tensor-core products,
# asynchronous copies and ldmatrix fragment loads in flash prefill and
# paged prefill, asynchronous copies in paged decode and in the dense
# decode kernel's split body, 16-byte code loads and score stores in the
# score-only LUT kernel, and in encode the cluster barrier's arrive and
# wait, the generic loads of the peers' shared rows (distributed shared
# memory) and the vector key loads (8 bytes of bf16, 16 of fp32)
SASS_OPS = {"flash_prefill": ("HMMA.16816.F32.BF16", "LDGSTS", "LDSM"),
            "paged_prefill": ("HMMA.16816.F32.BF16", "LDGSTS", "LDSM"),
            "paged_decode": ("LDGSTS",),
            "polar_attention": ("LDGSTS",),
            "polar_qk": ("LDG.E.128", "STG.E.128"),
            "polar_encode": ("UCGABAR_ARV", "UCGABAR_WAIT", "LD.E ",
                             "LDG.E.64", "LDG.E.128")}


def sass_counts(name: str) -> tuple[dict, str]:
    """Counts of the ``SASS_OPS`` opcodes in kernel ``name``'s library
    (``cuobjdump -sass``), and the first line holding the first opcode."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    ops = SASS_OPS[name]
    counts = {op: sum(op in ln for ln in sass) for op in ops}
    first = next((ln.strip() for ln in sass if ops[0] in ln), "")
    return counts, first


def ptxas_lines(log: str) -> list[str]:
    """ptxas' verbose report, per kernel instantiation: its mangled name,
    stack and spills, then registers."""
    return [ln.split("Function properties for ")[1].strip()
            if "Function properties for " in ln else
            ln.split("Used ")[1].strip() if "Used " in ln else ln.strip()
            for ln in log.splitlines()
            if "Function properties for " in ln or "Used " in ln
            or "spill" in ln]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    res = _build.build()
    regs = {name: ptxas_lines(r["log"]) for name, r in res.items()}
    print(f"build: {time.monotonic() - t0:.1f} s for {sorted(res)}; ptxas "
          f"{json.dumps(regs)}", flush=True)
    for name in SASS_OPS:
        counts, first = sass_counts(name)
        assert all(counts.values()), f"{name}: SASS lacks {counts}"
        print(f"sass: {name} {json.dumps(counts)}; first: {first}",
              flush=True)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def reset_counts(counters) -> None:
    """Set every launch counter of the kernel wrappers to 0."""
    from repro_torch.serve.graphs import COUNTERS
    for mod in counters:
        for attr in COUNTERS:
            if hasattr(mod, attr):
                setattr(mod, attr, 0)


def read_counts(counters) -> dict:
    """Launches since the last reset, per kernel form: ``name`` counts
    the launches on fp value rows (every launch of a kernel without value
    rows), ``name[u8]`` those on uint8 value rows; the encode's launches
    on the fixed angle grid count as ``polar_encode[fixed]``, flash
    prefill's serving launches in mode ``full`` as ``flash_prefill[full]``
    and its training launches (with the log-sum-exp) as
    ``flash_prefill[lse]``."""
    out = {}
    for mod in counters:
        name = mod.__name__.rsplit(".", 1)[1]
        forms = {f: getattr(mod, f"launches_{f}", None)
                 for f in ("u8", "fixed", "full", "lse")}
        out[name] = mod.launches - sum(n or 0 for n in forms.values())
        for f, n in forms.items():
            if n is not None:
                out[f"{name}[{f}]"] = n
    return out


def polar_layers(cfg) -> int:
    """The layers of ``cfg.policy`` whose codec has the page-native kernels
    (polar): only they launch encode and attention kernels on the serving
    paths; the other codecs' layers run plain PyTorch ops."""
    return sum(cfg.policy.layer_config(i).codec.supports_paged_decode
               for i in range(cfg.num_layers))


def encode_name(cfg) -> str:
    """The encode row a model's polar layers count on:
    ``polar_encode[fixed]`` on the fixed angle grid."""
    grids = {q.theta_stats for q in (cfg.policy.layer_config(i)
                                     for i in range(cfg.num_layers))
             if q.codec.supports_paged_decode}
    assert len(grids) <= 1, grids
    return "polar_encode[fixed]" if grids == {"fixed"} else "polar_encode"


def decode_flushes(cfg, steps: int) -> int:
    """Encodes of the decode form (``polar_encode[decode]``) among
    ``steps`` flush launches per polar layer: none on the fixed grid,
    whose row counts both forms."""
    return polar_layers(cfg) * steps if encode_name(cfg) == "polar_encode" \
        else 0


def encode_forms(launches: dict, flushes: int) -> dict:
    """``launches`` with the encode launches split by form, from the exact
    count a phase has asserted: ``flushes`` launches of the decode form
    (``polar_encode[decode]``: a decode step's flush of the residual
    groups), the rest of the prefill form (``polar_encode``)."""
    assert 0 <= flushes <= launches["polar_encode"], (launches, flushes)
    return {**launches, "polar_encode": launches["polar_encode"] - flushes,
            "polar_encode[decode]": flushes}


@contextlib.contextmanager
def booked_launches(counters, spans: dict):
    """Book the launches made inside calls. ``spans`` maps a name to
    (module, function name, test of the call's arguments); while the
    context is open, each call that passes its test adds the launches it
    made (:func:`read_counts` after it less before it) to the yielded
    dict's entry of that name. Spans may nest."""
    booked: dict = {name: {} for name in spans}

    def wrap(name, fn, when):
        def call(*args, **kw):
            if not when(*args, **kw):
                return fn(*args, **kw)
            before = read_counts(counters)
            out = fn(*args, **kw)
            for k, n in read_counts(counters).items():
                booked[name][k] = booked[name].get(k, 0) + n - before[k]
            return out
        return call

    with contextlib.ExitStack() as stack:
        for name, (mod, attr, when) in spans.items():
            stack.enter_context(mock.patch.object(
                mod, attr, wrap(name, getattr(mod, attr), when)))
        yield booked


def value_form(cfg) -> str:
    """The suffix of the kernel forms a model's cache reads: ``"[u8]"``
    under quantized values, else ``""``."""
    return "[u8]" if cfg.quant.value_bits else ""


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _encode_pools(torch, dev, pp=65):
    """Zeroed code and stat pools of ``pp`` pages."""
    return (torch.zeros((pp, HKV, G, P), dtype=torch.uint8, device=dev),
            *(torch.zeros((pp, HKV, 1, P), device=dev) for _ in range(4)))


def _encode_inputs(torch, dev, gen):
    """The two serving forms of the encode at the main path's shapes: the
    prefill form (one 1024-token bf16 prompt into 8 pages, fragmented) and
    the decode form (8 slots' bf16 residual groups, page ids of the
    flushing slots, -1 for the others) with no slot and with one slot
    flushing. Returns (k, pages, residual, {label: decode pages})."""
    k = torch.randn((1, HKV, 1024, D), generator=gen, device=dev).to(
        torch.bfloat16)
    pages = torch.tensor([[9, 3, 40, 0, 63, 17, 5, 28]], dtype=torch.int32,
                         device=dev)
    res = torch.randn((8, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    flushing = {"no slot flushing": [-1] * 8,
                "one slot flushing": [-1, -1, 11, -1, -1, -1, -1, -1]}
    return k, pages, res, {lb: torch.tensor(x, dtype=torch.int32,
                                            device=dev)[:, None]
                           for lb, x in flushing.items()}


def check_encode(torch, dev, gen, flush) -> list[dict]:
    """Encode (#1) in its three forms — paged prefill, paged decode with
    none, one and some slots flushing, dense — codes and stats exactly
    equal to the plain version, skipped pages untouched; timed in the
    prefill form and in the decode form with no slot and one slot
    flushing. Returns the prefill form's row and the decode form's (whose
    time is the one-slot flush)."""
    from repro_torch.kernels import polar_encode as pe
    k, pages, res, dforms = _encode_inputs(torch, dev, gen)
    k[0, 0, :5, :3] = 0.0           # zero pairs: the theta pin
    k[0, 1, 7, 4] = 1e-39           # denormal: the flush
    res[3, 2, :2, :5] = 0.0
    res[2, 0, 9, 7] = -1e-40
    pk, pp_ = _encode_pools(torch, dev), _encode_pools(torch, dev)
    pe.polar_encode_pages(k, pages, *pk)
    pe.polar_encode_pages_plain(k, pages, *pp_)
    # decode form: every slot's residual, only flushing slots write
    some = torch.tensor([[12], [-1], [13], [-1], [-1], [14], [-1], [64]],
                        dtype=torch.int32, device=dev)
    for fpages in (*dforms.values(), some):
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
    written = {*pages.flatten().tolist(), 11, 12, 13, 14, 64}
    untouched = [i for i in range(pk[0].shape[0]) if i not in written]
    assert all(int(x[untouched].abs().sum()) == 0 for x in pk), \
        "skipped pages written"

    def timed(kk, pg):
        return (time_ms(torch, lambda: pe.polar_encode_pages(kk, pg, *pk),
                        flush=flush),
                time_ms(torch, lambda: pe.polar_encode_pages_plain(
                    kk, pg, *pp_), iters=10, flush=flush,
                    lead_cycles=PLAIN_LEAD))

    def enc_bound(tokens, pg):
        # bytes: the page list, the flushing groups' keys, codes and stats;
        # ~22 fp32 operations per pair (see PERF.md)
        nbytes = pg.numel() * 4 + tokens * HKV * (D * 2 + P) \
            + 4 * (tokens // G) * HKV * P * 4
        return bound(nbytes, 22 * tokens * HKV * P, "fp32")

    def row(form, ms, plain_ms, tokens, pg, shape):
        b_ms, by = enc_bound(tokens, pg)
        return {"name": f"polar_encode{form}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/polar_encode.cu",
                "replaces": "src/repro/kernels/polar_encode.py:51",
                "max_abs_err": float(max(code_err, stat_err)), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": None, "shape": shape}

    rows = [row("", *timed(k, pages), 1024, pages,
                "prefill form, 1 x 4 kv heads x 1024 tokens x 64 bf16")]
    decode = {lb: (*timed(res, pg), G * int((pg >= 0).sum()), pg)
              for lb, pg in dforms.items()}
    rows.append(row("[decode]", *decode["one slot flushing"],
                    "decode form, 8 slots x 4 kv heads x one 128-token "
                    "bf16 residual group, one slot flushing"))
    print("encode[decode]: 8 slots x 4 kv heads x one 128-token residual "
          "group, bf16: " + "; ".join(
              f"{lb} {ms:.4f} ms (plain {plain:.4f} ms, bound "
              f"{enc_bound(tok, pg)[0]:.4f} ms)"
              for lb, (ms, plain, tok, pg) in decode.items()), flush=True)
    rows.append(check_encode_fixed(torch, dev, flush, k, pages, res,
                                   dforms["one slot flushing"], some))
    return rows


def check_encode_fixed(torch, dev, flush, k, pages, res, dpages,
                       some) -> dict:
    """#1 on the fixed angle grid (``theta_stats="fixed"``) in its three
    forms on the inputs of :func:`check_encode`, plus a pair at theta ==
    2pi exactly: codes and stats bit-equal to the plain version, skipped
    pages untouched; timed in the prefill form (the row) and the decode
    form with one slot flushing (its own line)."""
    from repro_torch.kernels import polar_encode as pe
    k = k.clone()
    k[0, 2, 11, 3], k[0, 2, 11, 3 + P] = -1.0, 0.0   # atan2(+0, -1) + pi
    pk, pp_ = _encode_pools(torch, dev), _encode_pools(torch, dev)
    for kk, pg in ((k, pages), (res, dpages), (res, some)):
        pe.polar_encode_pages(kk, pg, *pk, fixed=True)
        pe.polar_encode_pages_plain(kk, pg, *pp_, fixed=True)
    dk = pe.polar_encode(k, fixed=True)
    dp = pe.polar_encode_plain(k, fixed=True)
    torch.cuda.synchronize()
    err = max(max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(x, y)) for x, y in ((pk, pp_), (dk, dp)))
    assert err == 0.0, f"fixed-grid encode differs from the plain version "\
        f"({err})"
    assert int(dk[0][0, 2, 0, 11, 3]) & 15 == 15, "theta == 2pi not clipped"
    assert float(dk[3].max()) == float(dk[3].min()) > 0 and \
        not dk[4].any()
    written = {*pages.flatten().tolist(), 11, 12, 13, 14, 64}
    untouched = [i for i in range(pk[0].shape[0]) if i not in written]
    assert all(int(x[untouched].abs().sum()) == 0 for x in pk), \
        "skipped pages written"

    def timed(kk, pg):
        return (time_ms(torch, lambda: pe.polar_encode_pages(
                    kk, pg, *pk, fixed=True), flush=flush),
                time_ms(torch, lambda: pe.polar_encode_pages_plain(
                    kk, pg, *pp_, fixed=True), iters=10, flush=flush,
                    lead_cycles=PLAIN_LEAD))

    def enc_bound(tokens, pg):
        # the bytes of check_encode's bound; ~20 fp32 operations per pair
        # (no theta min/max)
        nbytes = pg.numel() * 4 + tokens * HKV * (D * 2 + P) \
            + 4 * (tokens // G) * HKV * P * 4
        return bound(nbytes, 20 * tokens * HKV * P, "fp32")

    ms, plain_ms = timed(k, pages)
    b_ms, by = enc_bound(1024, pages)
    dms, dplain = timed(res, dpages)
    print(f"encode[fixed]: the fixed angle grid, bit-equal to the plain "
          f"version in the prefill, decode and dense forms; prefill form "
          f"(1 x 4 kv heads x 1024 tokens, bf16) {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms); decode form (8 slots' "
          f"residual groups, one slot flushing) {dms:.4f} ms (plain "
          f"{dplain:.4f} ms, bound {enc_bound(G, dpages)[0]:.4f} ms)",
          flush=True)
    return {"name": "polar_encode[fixed]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/polar_encode.cu",
            "replaces": "src/repro/kernels/polar_encode.py:51",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": "prefill form on the fixed angle grid, 1 x 4 kv heads "
                     "x 1024 tokens x 64 bf16 (launches: both forms)"}


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
    perm = torch.randperm(scratch, generator=gen, device=dev)
    table = perm[:s * n].reshape(s, n).to(torch.int32)
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

    # the long-context shape: 1 slot x 32 live pages (4096 tokens), bf16
    # values, against the plain version and timed on a line of its own
    n_long = 32
    q_l = q[:1].contiguous()
    table_l = perm[:n_long].reshape(1, n_long).to(torch.int32)
    fl_l = torch.full((1,), n_long * G, dtype=torch.int32, device=dev)
    got = pd.polar_paged_decode_grouped(q_l, codes, rs, rz, ts, tz, vb,
                                        table_l, fl_l)
    ref = pd.polar_paged_decode_grouped_plain(q_l, codes, rs, rz, ts, tz, vb,
                                              table_l, fl_l)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=FP32_TOL, atol=FP32_TOL)
    errs.append(float((got[0] - ref[0]).abs().max()))
    l_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(
        q_l, codes, rs, rz, ts, tz, vb, table_l, fl_l), flush=flush)
    l_b, l_by = bound(
        q_l.numel() * 4 + n_long * HKV * (G * P + 4 * P * 4 + G * D * 2)
        + n_long * 4 + 4 + HKV * QH * (D + 2) * 4,
        n_long * HKV * (3 * QH * P * 16 + 2 * G * P + 2 * QH * G * P
                        + 4 * QH * G + 2 * QH * G * D))
    print(f"decode[long shape]: paged_decode 1 slot x {HKV} kv heads x {QH} "
          f"query heads x {n_long} live pages ({n_long * G} tokens), bf16 "
          f"values, nsplit {pd.plan_splits(1, HKV, n_long)}: {l_ms:.4f} ms "
          f"(bound {l_b:.4f} ms {l_by}); err {errs[-1]:.3g}", flush=True)

    # timing: every slot at 8 live pages (1024 tokens), bf16 values
    table_t = perm[:s * n].reshape(s, n).to(torch.int32)
    fl_t = torch.full((s,), n * G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(
        q, codes, rs, rz, ts, tz, vb, table_t, fl_t), flush=flush)
    plain_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped_plain(
        q, codes, rs, rz, ts, tz, vb, table_t, fl_t), iters=10, flush=flush,
        lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the slots' keys
    # gathered from their pages and dequantized beforehand (outside the
    # timed window), fp32, under the length mask
    tl = table_t.long()
    kf = _paged_keys(torch, codes, (rs, rz, ts, tz), tl).repeat_interleave(
        QH, 1)
    vf = vb[tl].transpose(1, 2).reshape(s, HKV, n * G, D).float() \
        .repeat_interleave(QH, 1)
    qf4 = q.reshape(s, HKV * QH, 1, D)
    mask = (torch.arange(n * G, device=dev)[None, :] < fl_t[:, None])[
        :, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qf4, kf, vf, attn_mask=mask,
                                         scale=1.0), flush=flush)
    pages = s * n * HKV
    nbytes = q.numel() * 4 + pages * (G * P + 4 * P * 4 + G * D * 2) \
        + table_t.numel() * 4 + s * 4 + s * HKV * QH * (D + 2) * 4
    # per (page, kv head): LUT 3*Qh*P*2^t, rho~ 2*g*P once for every row,
    # scores one FMA on a gathered LUT entry 2*Qh*g*P, softmax ~4*Qh*g,
    # p@V 2*Qh*g*d
    flops = pages * (3 * QH * P * 16 + 2 * G * P + 2 * QH * G * P
                     + 4 * QH * G + 2 * QH * G * D)
    b_ms, by = bound(nbytes, flops, "fp32")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:104",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over gathered pre-dequantized keys (fp32, "
                       "length mask)",
            "shape": "8 slots x 4 kv heads x 8 query heads x 8 live pages, "
                     f"nsplit {pd.plan_splits(s, HKV, n)}"}


def check_prefill(torch, dev, gen, flush) -> dict:
    """fp32 inputs run the FMA body (1e-4), bf16 the tensor-core body
    (2^-7); timed at a 1024-token serve prompt and, on a line of its own,
    at the static phase's 8 x 1000-token prefill."""
    from repro_torch.kernels import flash_prefill as fpk
    h = 32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = []
    for b, t, dt in ((1, 1000, torch.float32), (1, 333, torch.float32),
                     (1, 333, torch.bfloat16), (SB, SPROMPT, torch.bfloat16),
                     (1, 1024, torch.bfloat16)):
        q = torch.randn((b, h, t, D), generator=gen, device=dev).to(dt)
        k = torch.randn((b, HKV, t, D), generator=gen, device=dev).to(dt)
        v = torch.randn((b, HKV, t, D), generator=gen, device=dev).to(dt)
        got = fpk.flash_prefill(q, k, v)
        ref = fpk.flash_prefill_plain(q, k, v)
        torch.cuda.synchronize()
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
        else:
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=BF16_RTOL, atol=BF16_RTOL)
        errs.append(float((got.float() - ref.float()).abs().max()))
        if b == SB:
            # yardstick only: the port never calls SDPA
            st_ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v),
                            flush=flush)
            ke = k.repeat_interleave(h // HKV, dim=1)
            ve = v.repeat_interleave(h // HKV, dim=1)
            st_lib = time_ms(torch, lambda: sdpa(q, ke, ve, is_causal=True),
                             flush=flush)
            st_b, _ = bound((2 * h + 2 * HKV) * b * t * D * 2,
                            4.0 * b * h * D * (t * (t + 1) / 2), "bf16")
            print(f"prefill[static shape]: flash_prefill {SB} x {h} heads "
                  f"({HKV} kv) x {t} tokens x {D} bf16, causal: {st_ms:.4f} "
                  f"ms a layer (SDPA {st_lib:.4f} ms, bound {st_b:.4f} ms "
                  f"operations); err {errs[-1]:.3g}", flush=True)
    t = 1024
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v), flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(q, k, v),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only: the port never calls it
    ke = k.repeat_interleave(h // HKV, dim=1)
    ve = v.repeat_interleave(h // HKV, dim=1)
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
            "library": "SDPA",
            "shape": "1 x 32 heads (4 kv) x 1024 tokens x 64 bf16, causal"}


def check_paged_prefill(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import paged_prefill as ppk
    pp = 65
    scratch = pp - 1
    qt = QH * TC
    codes = torch.randint(0, 256, (pp, HKV, G, P), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)

    def stat(lo, hi):
        return lo + (hi - lo) * torch.rand((pp, HKV, 1, P), generator=gen,
                                           device=dev)

    stats = (stat(0.01, 0.3), stat(0.0, 1.0), stat(0.05, 0.4),
             stat(0.0, 0.5))
    vals = torch.randn((pp, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(scratch, generator=gen, device=dev)[:32].to(
        torch.int32)
    for x in (*stats, vals):
        x[scratch] = float("nan")
    q = torch.randn((HKV, qt, D), generator=gen, device=dev) * D ** -0.5
    errs = []
    # start 0 (no page read), 384 over a fragmented row, 1024 (the system
    # prompt of the prefix phase), 2048; full and ragged chunks; fp32 chunk
    # K/V (the FMA body) and bf16 (the tensor-core body, as served); the
    # value page at `start` and the chunk rows past chunk_len poisoned,
    # dead table entries on the NaN scratch page
    for start in (0, 384, 1024, 2048):
        for clen in (TC, 77):
            for kvdt in (torch.float32, torch.bfloat16):
                n_live = -(-(start + clen) // G)
                row = perm.clone()
                row[n_live:] = scratch
                v = vals.clone()
                v[int(row[start // G])] = float("nan")
                kc = torch.randn((HKV, TC, D), generator=gen,
                                 device=dev).to(kvdt)
                vc = torch.randn((HKV, TC, D), generator=gen,
                                 device=dev).to(kvdt)
                kc[:, clen:] = float("nan")
                vc[:, clen:] = float("nan")
                width = 1 << (n_live - 1).bit_length()
                n_mma = ppk.launches_mma
                got = ppk.polar_paged_prefill_grouped(
                    q, kc, vc, codes, *stats, v, row[:width], start, clen)
                assert ppk.launches_mma == n_mma + (kvdt == torch.bfloat16), \
                    "bf16 chunk K/V and values must run the tensor-core body"
                ref = ppk.polar_paged_prefill_grouped_plain(
                    q, kc, vc, codes, *stats, v, row[:width], start, clen)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), "NaN leaked into prefill"
                torch.testing.assert_close(got, ref, rtol=FP32_TOL,
                                           atol=FP32_TOL)
                errs.append(float((got - ref).abs().max()))

    def work(start):
        """(bytes, {kind: operations}, old fp32 operations) of one launch at
        ``start`` with a full chunk: the q.k~ / q.k products and both p.V
        at the bf16 tensor-core peak, counted once; per (kv head, page) the
        dequantization (4 per angle state: theta~ and its sincos, 4 per
        (token, pair): rho~ and k~) and the softmax (~4 per (row, key)) at
        the fp32 peak. The old count ran everything as fp32: per
        (kv head, page) LUT 3*QT*P*2^t, rho~ 2*g*P, one FMA per gathered
        LUT entry 2*QT*g*P, softmax 4*QT*g, p@V 2*QT*g*d, and (4d + 4) per
        causal pair of the chunk."""
        n = start // G
        nbytes = (HKV * n * (G * P + 4 * P * 4 + G * D * 2) + n * 4
                  + q.numel() * 4 + 2 * HKV * TC * D * 2 + HKV * qt * D * 4)
        causal = QH * TC * (TC + 1) // 2      # (row, key) pairs per kv head
        pairs = HKV * (qt * start + causal)
        ops = {"bf16": 4.0 * D * pairs,
               "fp32": HKV * n * (4 * P * 16 + 4 * G * P) + 4.0 * pairs}
        old = HKV * n * (3 * qt * P * 16 + 2 * G * P + 2 * qt * G * P
                         + 4 * qt * G + 2 * qt * G * D) \
            + HKV * causal * (4 * D + 4)
        return nbytes, ops, old

    # timing: start 1024 (8 live pages) + a full 256-token chunk, bf16 as
    # on the main path; then start 2048 (16 pages) on a line of its own
    start, n = 1024, 8
    row = perm[:n].contiguous()
    kc = torch.randn((HKV, TC, D), generator=gen, device=dev).to(
        torch.bfloat16)
    vc = torch.randn((HKV, TC, D), generator=gen, device=dev).to(
        torch.bfloat16)
    ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped(
        q, kc, vc, codes, *stats, vals, row, start, TC), flush=flush)
    plain_ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped_plain(
        q, kc, vc, codes, *stats, vals, row, start, TC), iters=5,
        flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the prefix keys
    # dequantized beforehand (outside the timed window) and concatenated
    # with the chunk keys, under the same boolean mask, in fp32 — and, for
    # context only, the same call in bf16
    rl = row.long()
    k_pre = _paged_keys(torch, codes, stats, rl[None])[0]
    v_pre = vals[rl].transpose(0, 1).reshape(HKV, start, D).float()
    rep = QH
    k_all = torch.cat([k_pre, kc.float()], 1).repeat_interleave(rep, 0)
    v_all = torch.cat([v_pre, vc.float()], 1).repeat_interleave(rep, 0)
    q_h = q.reshape(HKV * QH, TC, D)
    i = torch.arange(TC, device=dev)
    mask = torch.cat([torch.ones((TC, start), dtype=torch.bool, device=dev),
                      i[:, None] >= i[None, :]], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q_h[None], k_all[None], v_all[None],
                                         attn_mask=mask, scale=1.0),
                     flush=flush)
    qb, kb, vb = (x[None].to(torch.bfloat16) for x in (q_h, k_all, v_all))
    lib_bf16_ms = time_ms(torch, lambda: sdpa(qb, kb, vb, attn_mask=mask,
                                              scale=1.0), flush=flush)
    nbytes, ops, old = work(start)
    b_ms, by = bound(nbytes, ops)
    old_ms, _ = bound(nbytes, old, "fp32")
    # start 2048: 16 prefix pages
    row2 = perm[:16].contiguous()
    ms2 = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped(
        q, kc, vc, codes, *stats, vals, row2, 2048, TC), flush=flush)
    b2, by2 = bound(*work(2048)[:2])
    print(f"paged_prefill: tensor-core body at start {start}: {ms:.4f} ms, "
          f"bound {b_ms:.4f} ms {by} (products at the bf16 peak; the old "
          f"all-fp32 count gives {old_ms:.4f} ms); SDPA fp32 {lib_ms:.4f} "
          f"ms, SDPA bf16 (context only) {lib_bf16_ms:.4f} ms; at start 2048 "
          f"(16 pages): {ms2:.4f} ms, bound {b2:.4f} ms {by2}", flush=True)
    return {"name": "paged_prefill", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_prefill.cu",
            "replaces": "src/repro/kernels/paged_prefill.py:136",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over pre-dequantized keys (fp32, bool mask)",
            "shape": "4 kv heads x 8 query heads x 256-token chunk over "
                     "8 prefix pages (1024 tokens)"}


def _dense_cache(torch, dev, gen, flushed_groups=8):
    """Dense static-phase buffers: codes/stats of ``flushed_groups`` groups
    from the dense encode kernel (the later groups zero, as an unflushed
    cache holds them), bf16 value rows."""
    from repro_torch.kernels import polar_encode as pe
    k = torch.randn((SB, HKV, flushed_groups * G, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    enc = pe.polar_encode(k)
    bufs = [torch.zeros((SB, HKV, SG, *x.shape[3:]), dtype=x.dtype,
                        device=dev) for x in enc]
    for b, x in zip(bufs, enc):
        b[:, :, :flushed_groups] = x
    vals = torch.randn((SB, HKV, SMAX, D), generator=gen, device=dev).to(
        torch.bfloat16)
    return bufs, vals


def _dequant(torch, bufs):
    """fp32 keys of the dense buffers (B, Hkv, G*g, d), for the library
    yardsticks (computed outside the timed window)."""
    from repro_torch.core import quantizers as qz
    pk = qz.PolarKeys(codes=bufs[0], rho_scale=bufs[1], rho_zero=bufs[2],
                      theta_scale=bufs[3], theta_zero=bufs[4], rho_bits=4,
                      theta_bits=4, pairing="half")
    b, hkv, gc, g, p = bufs[0].shape
    return qz.decode_polar_keys(pk, torch.float32).reshape(b, hkv, gc * g,
                                                           2 * p)


def _paged_keys(torch, codes, stats, tl):
    """fp32 keys of pool pages ``tl`` (S, N) -> (S, Hkv, N*g, d), for the
    library yardsticks (computed outside the timed window)."""
    from repro_torch.core import quantizers as qz
    pk = qz.PolarKeys(codes=codes[tl].transpose(1, 2),
                      rho_scale=stats[0][tl].transpose(1, 2),
                      rho_zero=stats[1][tl].transpose(1, 2),
                      theta_scale=stats[2][tl].transpose(1, 2),
                      theta_zero=stats[3][tl].transpose(1, 2), rho_bits=4,
                      theta_bits=4, pairing="half")
    k = qz.decode_polar_keys(pk, torch.float32)
    hkv, g, p = codes.shape[1:]
    return k.reshape(tl.shape[0], hkv, tl.shape[1] * g, 2 * p)


def _dense_flops(groups, with_attention=True):
    """Operations on ``groups`` (row, kv head, group) tiles: LUT build
    3*Qh*P*2^t, rho~ 2*g*P once for every row, one FMA per gathered LUT
    entry 2*Qh*g*P; the fused kernel adds softmax ~4*Qh*g and p@V
    2*Qh*g*d."""
    per = 3 * QH * P * 16 + 2 * G * P + 2 * QH * G * P
    if with_attention:
        per += 4 * QH * G + 2 * QH * G * D
    return groups * per


def _partials_err(torch, got, ref) -> tuple[float, float]:
    """Flash partials (acc, m, l) of a decode kernel against its plain
    version: each finite and within rtol = atol = 1e-4; returns the max
    abs error of the normalized output acc / l (what the partials stand
    for, as ``check_decode`` reports it) and of the raw partials."""
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all(), "NaN leaked from a dead row"
        torch.testing.assert_close(a, r, rtol=FP32_TOL, atol=FP32_TOL)
    live = ref[2] > 0
    o_k = got[0] / torch.where(live, got[2], 1.0)[..., None]
    o_r = ref[0] / torch.where(live, ref[2], 1.0)[..., None]
    torch.testing.assert_close(o_k, o_r, rtol=FP32_TOL, atol=FP32_TOL)
    return (float((o_k - o_r).abs().max()),
            max(float((a - r).abs().max()) for a, r in zip(got, ref)))


def check_polar_attention(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import polar_attention as pak
    bufs, vals = _dense_cache(torch, dev, gen)
    q = torch.randn((SB, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    errs = []
    # per-row lengths: the static phase's 1024, empty, partial and whole
    # groups; every value row (and every stat row) past a row's length
    # NaN-poisoned
    for lens in ([1024] * SB, [1024, 900, 0, 128, 1, 513, 640, 1023]):
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        v = vals.clone()
        st = [x.clone() for x in bufs[1:]]
        for i, n in enumerate(lens):
            v[i, :, n:] = float("nan")
            for x in st:
                x[i, :, -(-n // G):] = float("nan")
        got = pak.polar_decode_attention_grouped(q, bufs[0], *st, v, length)
        ref = pak.polar_decode_attention_grouped_plain(q, bufs[0], *st, v,
                                                       length)
        errs.append(_partials_err(torch, got, ref))
    # timing: every row at 8 flushed groups, bf16 values (the static phase)
    length = torch.full((SB,), 8 * G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
        q, *bufs, vals, length), flush=flush)
    plain_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped_plain(
        q, *bufs, vals, length), iters=10, flush=flush,
        lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the keys
    # dequantized beforehand, fp32, under the length mask
    kf = _dequant(torch, bufs).repeat_interleave(QH, 1)
    vf = vals.float().repeat_interleave(QH, 1)
    qf = q.reshape(SB, HKV * QH, 1, D)
    mask = (torch.arange(SMAX, device=dev) < 8 * G)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qf, kf, vf, attn_mask=mask,
                                         scale=1.0), flush=flush)
    groups = SB * HKV * 8
    nbytes = q.numel() * 4 + groups * (G * P + 4 * P * 4 + G * D * 2) \
        + SB * 4 + SB * HKV * QH * (D + 2) * 4
    b_ms, by = bound(nbytes, _dense_flops(groups), "fp32")
    return {"name": "polar_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/polar_attention.cu",
            "replaces": "src/repro/kernels/polar_attention.py:104",
            "max_abs_err": max(e[0] for e in errs),
            "partials_err": max(e[1] for e in errs), "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over pre-dequantized keys (fp32, length mask)",
            "shape": "8 rows x 4 kv heads x 8 query heads x 8 flushed "
                     "groups of a 1152-token buffer"}


def check_qk_scores(torch, dev, gen, flush) -> dict:
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    bufs, _ = _dense_cache(torch, dev, gen)
    q = torch.randn((SB, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    errs = []
    for t_bits in (4, 3):
        enc = bufs
        if t_bits == 3:   # the 3-bit sweep of tests/test_kernels.py
            k = torch.randn((SB, HKV, SMAX, D), generator=gen, device=dev)
            enc = list(pe.polar_encode(k, r_bits=3, t_bits=3))
        got = qkk.polar_qk_scores(q, *enc, r_bits=t_bits, t_bits=t_bits)
        ref = qkk.polar_qk_scores_plain(q, *enc, r_bits=t_bits,
                                        t_bits=t_bits)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
        errs.append(float((got - ref).abs().max()))
    ms = time_ms(torch, lambda: qkk.polar_qk_scores(q, *bufs), flush=flush)
    plain_ms = time_ms(torch, lambda: qkk.polar_qk_scores_plain(q, *bufs),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only: one matmul of q against the pre-dequantized keys
    kt = _dequant(torch, bufs).transpose(-1, -2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.matmul(q, kt), flush=flush)
    groups = SB * HKV * SG        # every group is scored
    nbytes = q.numel() * 4 + groups * (G * P + 4 * P * 4) \
        + SB * HKV * QH * SMAX * 4
    b_ms, by = bound(nbytes, _dense_flops(groups, with_attention=False),
                     "fp32")
    return {"name": "polar_qk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/polar_qk.cu",
            "replaces": "src/repro/kernels/polar_qk.py:68",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "matmul over pre-dequantized keys (fp32)",
            "shape": "8 rows x 4 kv heads x 8 query heads x 9 groups "
                     "(1152 tokens)"}


def check_paged_backends(torch, dev, gen, value_bits=0) -> float:
    """One fragmented paged cache with a NaN-poisoned scratch page, bf16
    or ``value_bits``-bit values: the paged engine's three decode backends
    agree within 1e-4 (fp32 q)."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.core.quantizers import QuantConfig
    s, n = 8, 8
    lay = PagedLayout(page_size=G, num_pages=s * n, slots=s,
                      pages_per_slot=n)
    c = pgc.init_paged_cache(QuantConfig(value_bits=value_bits), lay, HKV,
                             D, device=dev)
    perm = torch.randperm(lay.num_pages, generator=gen, device=dev)
    table = torch.full((s, n), lay.scratch_page, dtype=torch.int32,
                       device=dev)
    for sl, tl in enumerate((1000, 77, 128, 500, 1023, 256, 640, 900)):
        npg = -(-tl // G)
        table[sl, :npg] = perm[sl * n:sl * n + npg].to(torch.int32)
        k = torch.randn((1, HKV, npg * G, D), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((1, HKV, npg * G, D), generator=gen, device=dev).to(
            torch.bfloat16)
        pgc.paged_prefill(c, sl, table[sl], k, v, tl)
    values = (c.value_fp,) if c.value_fp is not None else (c.value_scale,
                                                            c.value_zero)
    for x in (*c.key_scales.values(), *values):
        x[lay.scratch_page] = float("nan")
    q = torch.randn((s, HKV * QH, D), generator=gen, device=dev)
    outs = {b: pgc.paged_decode_attention(c, q, table, backend=b)
            for b in pgc.DECODE_BACKENDS}
    torch.cuda.synchronize()
    err = 0.0
    for b, out in outs.items():
        assert torch.isfinite(out).all(), f"{b}: NaN from the scratch page"
        torch.testing.assert_close(out, outs["paged_fused"], rtol=FP32_TOL,
                                   atol=FP32_TOL)
        err = max(err, float((out - outs["paged_fused"]).abs().max()))
    return err


# uint8 value rows (QuantConfig.value_bits > 0): mid-tread codes with one
# fp32 scale and zero per (token, kv head) row, in kernels #2, #4 and #5


def _u8_values(torch, dev, gen, shape, bits=4):
    """uint8 mid-tread codes of random value rows of ``shape`` and their
    (…, 1) fp32 scale and zero (``quantizers.encode_values``)."""
    from repro_torch.core import quantizers as qz
    qv = qz.encode_values(torch.randn(shape, generator=gen, device=dev), bits)
    return qv.codes, qv.scale, qv.zero


def _poison_u8(vals, page):
    """NaN scales and zeros, and the largest code, on ``page``."""
    vc, vs, vz = vals
    vc[page] = 255
    vs[page] = float("nan")
    vz[page] = float("nan")


def _u8_row_bytes(rows: int) -> int:
    """Bytes of ``rows`` uint8 value rows with their scales and zeros."""
    return rows * (D + 8)


def check_decode_u8(torch, dev, gen, flush) -> dict:
    """Paged decode (#2) on uint8 value rows, at value_bits 4 and 8: slots
    flushed 0 ... 896 over a fragmented table whose dead entries hit a
    scratch page with NaN stats, scales and zeros; then the ``ops`` entry
    with ragged lengths (the residual's rows dequantized in PyTorch) on a
    width-sliced table; timed at 8 slots x 8 live pages."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    s, n, pp = 8, 8, 65
    scratch = pp - 1
    q, codes, *stats, _, table_t, fl_t = _decode_inputs(torch, dev, gen, s, n)
    for x in stats:
        x[scratch] = float("nan")
    flushed = torch.arange(0, s * G, G, dtype=torch.int32, device=dev)
    table = table_t.clone()
    for sl in range(s):
        table[sl, int(flushed[sl]) // G:] = scratch
    errs = []
    for bits in (4, 8):
        vals = _u8_values(torch, dev, gen, (pp, HKV, G, D), bits)
        _poison_u8(vals, scratch)
        kw = {"vscale": vals[1], "vzero": vals[2]}
        got = pd.polar_paged_decode_grouped(q, codes, *stats, vals[0], table,
                                            flushed, **kw)
        ref = pd.polar_paged_decode_grouped_plain(q, codes, *stats, vals[0],
                                                  table, flushed, **kw)
        torch.cuda.synchronize()
        for a in got:
            assert torch.isfinite(a).all(), "NaN leaked from the scratch page"
        live = ref[2] > 0
        o_k = got[0] / torch.where(live, got[2], 1.0)[..., None]
        o_r = ref[0] / torch.where(live, ref[2], 1.0)[..., None]
        for a, b in ((o_k, o_r), (got[1], ref[1]), (got[2], ref[2])):
            torch.testing.assert_close(a, b, rtol=FP32_TOL, atol=FP32_TOL)
        errs.append(float((o_k - o_r).abs().max()))
    # end to end through ops: ragged lengths, the page being filled real
    lengths = flushed + torch.tensor([5, 0, 127, 64, 1, 30, 100, 9],
                                     dtype=torch.int32, device=dev)
    for sl in range(s):
        table[sl, int(flushed[sl]) // G] = table_t[sl, int(flushed[sl]) // G]
    res = torch.randn((s, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    qf = torch.randn((s, HKV * QH, D), generator=gen, device=dev)
    full_k = ops.polar_paged_decode_attention_full(
        qf, codes, *stats, res, vals[0], table[:, :8], lengths, **kw)
    with mock.patch.object(pd, "polar_paged_decode_grouped",
                           pd.polar_paged_decode_grouped_plain):
        full_p = ops.polar_paged_decode_attention_full(
            qf, codes, *stats, res, vals[0], table[:, :8], lengths, **kw)
    torch.testing.assert_close(full_k, full_p, rtol=FP32_TOL, atol=FP32_TOL)
    errs.append(float((full_k - full_p).abs().max()))

    # timing: every slot at 8 live pages (1024 tokens), 4-bit value codes
    vc, vs, vz = _u8_values(torch, dev, gen, (pp, HKV, G, D), 4)
    args = (q, codes, *stats, vc, table_t, fl_t)
    kw = {"vscale": vs, "vzero": vz}
    ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(*args, **kw),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped_plain(
        *args, **kw), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the slots' keys
    # and values gathered and dequantized beforehand, fp32, length mask
    tl = table_t.long()
    kf = _paged_keys(torch, codes, stats, tl).repeat_interleave(QH, 1)
    vf = (vc[tl].float() * vs[tl] + vz[tl]).transpose(1, 2).reshape(
        s, HKV, n * G, D).repeat_interleave(QH, 1)
    mask = (torch.arange(n * G, device=dev)[None, :] < fl_t[:, None])[
        :, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q.reshape(s, HKV * QH, 1, D), kf,
                                         vf, attn_mask=mask, scale=1.0),
                     flush=flush)
    pages = s * n * HKV
    nbytes = q.numel() * 4 + pages * (G * P + 4 * P * 4 + _u8_row_bytes(G)) \
        + table_t.numel() * 4 + s * 4 + s * HKV * QH * (D + 2) * 4
    # as the bf16 form, plus p_t s_t and p_t z_t (4 per (query head, token))
    flops = pages * (3 * QH * P * 16 + 2 * G * P + 2 * QH * G * P
                     + 8 * QH * G + 2 * QH * G * D)
    b_ms, by = bound(nbytes, flops, "fp32")
    return {"name": "paged_decode[u8]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:81",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over gathered pre-dequantized keys and values "
                       "(fp32, length mask)",
            "shape": "8 slots x 4 kv heads x 8 query heads x 8 live pages, "
                     "4-bit value codes"}


def check_paged_prefill_u8(torch, dev, gen, flush) -> dict:
    """Paged prefill (#4) on uint8 prefix values at value_bits 4 and 8:
    start 0 ... 2048, full and ragged chunks, fp32 chunk K/V (the FMA
    body) and bf16 (the tensor-core body, as served: it must take every
    bf16 launch); NaN stats, scales and zeros on the scratch page behind
    the dead entries and on the value page at ``start``, NaN chunk rows
    past ``chunk_len``. Timed at start 1024 with a full bf16 chunk."""
    from repro_torch.kernels import paged_prefill as ppk
    pp = 65
    scratch = pp - 1
    qt = QH * TC
    q, _, _, codes, *stats, _, _, _, _ = _prefill_inputs(torch, dev, gen, 0)
    for x in stats:
        x[scratch] = float("nan")
    perm = torch.randperm(scratch, generator=gen, device=dev)[:32].to(
        torch.int32)
    errs = []
    for bits in (4, 8):
        vals = _u8_values(torch, dev, gen, (pp, HKV, G, D), bits)
        _poison_u8(vals, scratch)
        for start in (0, 384, 1024, 2048):
            for clen in (TC, 77):
                for kvdt in (torch.float32, torch.bfloat16):
                    n_live = -(-(start + clen) // G)
                    row = perm.clone()
                    row[n_live:] = scratch
                    v = [x.clone() for x in vals]
                    _poison_u8(v, int(row[start // G]))
                    kc, vc = (torch.randn((HKV, TC, D), generator=gen,
                                          device=dev).to(kvdt)
                              for _ in range(2))
                    kc[:, clen:] = float("nan")
                    vc[:, clen:] = float("nan")
                    width = 1 << (n_live - 1).bit_length()
                    args = (q, kc, vc, codes, *stats, v[0], row[:width],
                            start, clen)
                    kw = {"vscale": v[1], "vzero": v[2]}
                    n_mma = ppk.launches_mma
                    got = ppk.polar_paged_prefill_grouped(*args, **kw)
                    assert ppk.launches_mma == n_mma + \
                        (kvdt == torch.bfloat16), \
                        "uint8 values with bf16 chunk K/V must run the " \
                        "tensor-core body"
                    ref = ppk.polar_paged_prefill_grouped_plain(*args, **kw)
                    torch.cuda.synchronize()
                    assert torch.isfinite(got).all(), "NaN leaked"
                    torch.testing.assert_close(got, ref, rtol=FP32_TOL,
                                               atol=FP32_TOL)
                    errs.append(float((got - ref).abs().max()))

    # timing: start 1024 (8 live pages), a full bf16 chunk, 4-bit codes
    start, n = 1024, 8
    row = perm[:n].contiguous()
    vc_p, vs, vz = _u8_values(torch, dev, gen, (pp, HKV, G, D), 4)
    kc, vc = (torch.randn((HKV, TC, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    args = (q, kc, vc, codes, *stats, vc_p, row, start, TC)
    kw = {"vscale": vs, "vzero": vz}
    n_mma = ppk.launches_mma
    ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped(*args, **kw),
                 flush=flush)
    assert ppk.launches_mma > n_mma
    plain_ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped_plain(
        *args, **kw), iters=5, flush=flush, lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the prefix keys
    # and values dequantized beforehand, concatenated with the chunk's,
    # under the same boolean mask, fp32
    rl = row.long()
    k_pre = _paged_keys(torch, codes, stats, rl[None])[0]
    v_pre = (vc_p[rl].float() * vs[rl] + vz[rl]).transpose(0, 1).reshape(
        HKV, start, D)
    k_all = torch.cat([k_pre, kc.float()], 1).repeat_interleave(QH, 0)
    v_all = torch.cat([v_pre, vc.float()], 1).repeat_interleave(QH, 0)
    i = torch.arange(TC, device=dev)
    mask = torch.cat([torch.ones((TC, start), dtype=torch.bool, device=dev),
                      i[:, None] >= i[None, :]], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(
        q.reshape(HKV * QH, TC, D)[None], k_all[None], v_all[None],
        attn_mask=mask, scale=1.0), flush=flush)
    # the bf16 form's work (check_paged_prefill), with uint8 value rows:
    # codes + 8 bytes of scale and zero per row, and per (kv head, page)
    # the codes widened once (g*d) and per prefix (row, key) pair p_t s_t
    # and p_t z_t (4) in fp32
    causal = QH * TC * (TC + 1) // 2
    pairs = HKV * (qt * start + causal)
    nbytes = (HKV * n * (G * P + 4 * P * 4 + _u8_row_bytes(G)) + n * 4
              + q.numel() * 4 + 2 * HKV * TC * D * 2 + HKV * qt * D * 4)
    ops = {"bf16": 4.0 * D * pairs,
           "fp32": HKV * n * (4 * P * 16 + 4 * G * P + G * D) + 4.0 * pairs
           + 4.0 * HKV * qt * start}
    b_ms, by = bound(nbytes, ops)
    return {"name": "paged_prefill[u8]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_prefill.cu",
            "replaces": "src/repro/kernels/paged_prefill.py:103",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over pre-dequantized keys and values (fp32, "
                       "bool mask)",
            "shape": "4 kv heads x 8 query heads x 256-token bf16 chunk "
                     "over 8 prefix pages (1024 tokens), 4-bit value codes"}


def check_polar_attention_u8(torch, dev, gen, flush) -> dict:
    """Dense fused decode (#5) on uint8 value rows at value_bits 4 and 8:
    per-row lengths (1024 and ragged: empty, partial and whole groups)
    with every scale and zero past a row's length NaN; timed at the static
    phase's decode shape (8 flushed groups) with 4-bit codes."""
    from repro_torch.kernels import polar_attention as pak
    bufs, _ = _dense_cache(torch, dev, gen)
    q = torch.randn((SB, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    errs = []
    for bits in (4, 8):
        for lens in ([1024] * SB, [1024, 900, 0, 128, 1, 513, 640, 1023]):
            length = torch.tensor(lens, dtype=torch.int32, device=dev)
            vc, vs, vz = _u8_values(torch, dev, gen, (SB, HKV, SMAX, D), bits)
            st = [x.clone() for x in bufs[1:]]
            for i, n in enumerate(lens):
                vs[i, :, n:] = float("nan")
                vz[i, :, n:] = float("nan")
                for x in st:
                    x[i, :, -(-n // G):] = float("nan")
            kw = {"vscale": vs, "vzero": vz}
            got = pak.polar_decode_attention_grouped(q, bufs[0], *st, vc,
                                                     length, **kw)
            ref = pak.polar_decode_attention_grouped_plain(q, bufs[0], *st,
                                                           vc, length, **kw)
            errs.append(_partials_err(torch, got, ref))
    length = torch.full((SB,), 8 * G, dtype=torch.int32, device=dev)
    vc, vs, vz = _u8_values(torch, dev, gen, (SB, HKV, SMAX, D), 4)
    kw = {"vscale": vs, "vzero": vz}
    ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
        q, *bufs, vc, length, **kw), flush=flush)
    plain_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped_plain(
        q, *bufs, vc, length, **kw), iters=10, flush=flush,
        lead_cycles=PLAIN_LEAD)
    # yardstick only (the port never calls it): SDPA over the keys and
    # values dequantized beforehand, fp32, under the length mask
    kf = _dequant(torch, bufs).repeat_interleave(QH, 1)
    vf = (vc.float() * vs + vz).repeat_interleave(QH, 1)
    mask = (torch.arange(SMAX, device=dev) < 8 * G)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q.reshape(SB, HKV * QH, 1, D), kf,
                                         vf, attn_mask=mask, scale=1.0),
                     flush=flush)
    groups = SB * HKV * 8
    nbytes = q.numel() * 4 + groups * (G * P + 4 * P * 4 + _u8_row_bytes(G)) \
        + SB * 4 + SB * HKV * QH * (D + 2) * 4
    # the bf16 form's work plus one FMA per staged code (c * s + z)
    b_ms, by = bound(nbytes, _dense_flops(groups) + groups * 2 * G * D,
                     "fp32")
    return {"name": "polar_attention[u8]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/polar_attention.cu",
            "replaces": "src/repro/kernels/polar_attention.py:84",
            "max_abs_err": max(e[0] for e in errs),
            "partials_err": max(e[1] for e in errs), "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "SDPA over pre-dequantized keys and values (fp32, "
                       "length mask)",
            "shape": "8 rows x 4 kv heads x 8 query heads x 8 flushed "
                     "groups of a 1152-token buffer, 4-bit value codes"}


# ---------------------------------------------------------------------------
# the kernels at the paper's widths: head_dim 128, llama3.1-8b's 8 kv heads
# x 4 query heads, qwen1.5-4b's 20 x 1
# ---------------------------------------------------------------------------

#: (kv heads, query heads per kv head) of the ``[d128]`` rows (llama3.1-8b;
#: granite-8b has the same), the ``[d128,qh1]`` rows (qwen1.5-4b, MHA) and
#: the ``[d128,qh6]`` rows (dbrx-132b)
D128_SHAPES = {"[d128]": (8, 4), "[d128,qh1]": (20, 1), "[d128,qh6]": (8, 6)}
D128 = 128
#: a rank's shapes on the mesh phase's head-sharded llama3.1-8b: (kv heads,
#: query heads a kv head) of one of two ranks, and the model's kv heads
#: the paged decode plans its splits for
MESH_SHAPES = {"[d128,mesh2]": (4, 4)}
MESH_PLAN_HEADS = {"[d128,mesh2]": 8}


def _d128_shape(form: str) -> tuple[int, int]:
    return {**D128_SHAPES, **MESH_SHAPES}[form]


def _form_row(name, form, src, replaces, err, ms, plain_ms, b, lib_ms,
              library, shape) -> dict:
    return {"name": f"{name}{form}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "library": library, "shape": shape}


def _d128_stats(torch, dev, gen, pp, hkv, p):
    """Random code pool (PP, Hkv, g, P) and the four stat pools at the
    ranges of ``check_decode``."""
    codes = torch.randint(0, 256, (pp, hkv, G, p), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    stats = [lo + (hi - lo) * torch.rand((pp, hkv, 1, p), generator=gen,
                                         device=dev)
             for lo, hi in ((0.01, 0.3), (0.0, 1.0), (0.05, 0.4),
                            (0.0, 0.5))]
    return codes, stats


def check_encode_d128(torch, dev, gen, flush, form="[d128]") -> dict:
    """#1's prefill form at llama3.1-8b's 8 kv heads (a mesh rank's 4 for
    ``[d128,mesh2]``) x 1024 bf16 tokens x d 128 into 8 fragmented pages
    (P = 64 pairs): codes and stats bit-equal to the plain version, other
    pages untouched."""
    from repro_torch.kernels import polar_encode as pe
    hkv, d = _d128_shape(form)[0], D128
    p = d // 2
    k = torch.randn((1, hkv, 1024, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k[0, 0, :5, :3] = 0.0
    pages = torch.tensor([[9, 3, 40, 0, 63, 17, 5, 28]], dtype=torch.int32,
                         device=dev)

    def pools():
        return (torch.zeros((65, hkv, G, p), dtype=torch.uint8, device=dev),
                *(torch.zeros((65, hkv, 1, p), device=dev) for _ in range(4)))
    pk, pp_ = pools(), pools()
    pe.polar_encode_pages(k, pages, *pk)
    pe.polar_encode_pages_plain(k, pages, *pp_)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(pk, pp_))
    assert err == 0.0, f"encode at d 128 differs from the plain version {err}"
    untouched = [i for i in range(65) if i not in pages.flatten().tolist()]
    assert all(int(x[untouched].abs().sum()) == 0 for x in pk)
    ms = time_ms(torch, lambda: pe.polar_encode_pages(k, pages, *pk),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: pe.polar_encode_pages_plain(
        k, pages, *pp_), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    nbytes = pages.numel() * 4 + 1024 * hkv * (d * 2 + p) \
        + 4 * (1024 // G) * hkv * p * 4
    return _form_row(
        "polar_encode", form, "polar_encode.cu",
        "src/repro/kernels/polar_encode.py:51", err, ms, plain_ms,
        bound(nbytes, 22 * 1024 * hkv * p, "fp32"), None, None,
        f"prefill form, 1 x {hkv} kv heads x 1024 tokens x 128 bf16 "
        "(launches: both forms)")


def check_decode_d128(torch, dev, gen, flush, form) -> dict:
    """#2 at d 128, 8 slots over 8-page rows, bf16 values: slots flushed
    0 ... 896 with dead entries on a NaN scratch page, normalized output
    and softmax stats within 1e-4 of the plain version, every launch on
    the split body; timed with every slot at 8 live pages. A mesh rank's
    form plans its splits for the model's kv heads
    (:data:`MESH_PLAN_HEADS`), and its output is bit-equal to the same
    heads of the whole model's call."""
    from repro_torch.kernels import paged_decode as pd
    hkv, qh = _d128_shape(form)
    plan = {"plan_heads": MESH_PLAN_HEADS[form]} if form in MESH_SHAPES \
        else {}
    d, s, n = D128, 8, 8
    p, pp = d // 2, s * n + 1
    scratch = pp - 1
    codes, stats = _d128_stats(torch, dev, gen, pp, hkv, p)
    vals = torch.randn((pp, hkv, G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    table_t = torch.randperm(scratch, generator=gen, device=dev)[:s * n] \
        .reshape(s, n).to(torch.int32)
    fl_t = torch.full((s,), n * G, dtype=torch.int32, device=dev)
    flushed = torch.arange(0, s * G, G, dtype=torch.int32, device=dev)
    table = table_t.clone()
    for sl in range(s):
        table[sl, int(flushed[sl]) // G:] = scratch
    for x in (*stats, vals):
        x[scratch] = float("nan")
    n_split = pd.launches_split
    got = pd.polar_paged_decode_grouped(q, codes, *stats, vals, table,
                                        flushed, **plan)
    assert pd.launches_split == n_split + 1, "d 128 left the split body"
    ref = pd.polar_paged_decode_grouped_plain(q, codes, *stats, vals, table,
                                              flushed)
    err = _partials_err(torch, got, ref)[0]
    if plan:
        # the rank's heads are the first block of the model's: pad the
        # inputs to every head and run the whole model's call
        nb = plan["plan_heads"] // hkv

        def whole(x):
            return torch.cat([x] + [torch.zeros_like(x)] * (nb - 1), 1)
        full = pd.polar_paged_decode_grouped(
            whole(q), whole(codes), *(whole(x) for x in stats), whole(vals),
            table, flushed)
        assert all(torch.equal(a[:, :hkv], b) for a, b in zip(full, got)), \
            f"{form}: the shard's decode differs from the whole call's heads"
    args = (q, codes, *stats, vals, table_t, fl_t)
    ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(*args, **plan),
                 flush=flush)
    # the price of planning for the model's heads: the same call on the
    # shard's own plan (more splits, another merge order)
    own_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped(*args),
                     flush=flush) if plan else None
    plain_ms = time_ms(torch, lambda: pd.polar_paged_decode_grouped_plain(
        *args), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    tl = table_t.long()
    kf = _paged_keys(torch, codes, stats, tl).repeat_interleave(qh, 1)
    vf = vals[tl].transpose(1, 2).reshape(s, hkv, n * G, d).float() \
        .repeat_interleave(qh, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q.reshape(s, hkv * qh, 1, d), kf,
                                         vf, scale=1.0), flush=flush)
    pages = s * n * hkv
    nbytes = q.numel() * 4 + pages * (G * p + 4 * p * 4 + G * d * 2) \
        + table_t.numel() * 4 + s * 4 + s * hkv * qh * (d + 2) * 4
    flops = pages * (3 * qh * p * 16 + 2 * G * p + 2 * qh * G * p
                     + 4 * qh * G + 2 * qh * G * d)
    row = _form_row(
        "paged_decode", form, "paged_decode.cu",
        "src/repro/kernels/paged_decode.py:104", err, ms, plain_ms,
        bound(nbytes, flops, "fp32"), lib_ms,
        "SDPA over gathered pre-dequantized keys (fp32)",
        f"8 slots x {hkv} kv heads x {qh} query heads x 8 live pages x "
        f"d 128, bf16 values, nsplit "
        f"{pd.plan_splits(s, plan.get('plan_heads', hkv), n)}"
        + (f" (planned for {plan['plan_heads']} kv heads; bit-equal to "
           "those heads of the whole call; the shard's own plan, nsplit "
           f"{pd.plan_splits(s, hkv, n)}, takes {own_ms:.4f} ms)"
           if plan else ""))
    if plan:
        row["own_plan_ms"] = own_ms
    return row


def check_prefill_d128(torch, dev, gen, flush, form) -> dict:
    """#3 at a serving prefill of 1024 tokens x d 128, bf16, causal: at
    llama3.1-8b's 32 heads over 8 kv heads (``[d128]``), qwen1.5-4b's 20
    over 20 (``[d128,qh1]``) or dbrx-132b's 48 over 8 (``[d128,qh6]``),
    within one bf16 step (2^-7) of the plain version."""
    from repro_torch.kernels import flash_prefill as fpk
    hkv, qh = _d128_shape(form)
    h, t, d = hkv * qh, 1024, D128
    q = torch.randn((1, h, t, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, hkv, t, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    got = fpk.flash_prefill(q, k, v)
    ref = fpk.flash_prefill_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_RTOL,
                               atol=BF16_RTOL)
    err = float((got.float() - ref.float()).abs().max())
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v), flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(q, k, v),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q, ke, ve, is_causal=True),
                     flush=flush)
    return _form_row(
        "flash_prefill", form, "flash_prefill.cu",
        "src/repro/kernels/flash_prefill.py:77", err, ms, plain_ms,
        bound((2 * h + 2 * hkv) * t * d * 2,
              4.0 * h * d * (t * (t + 1) / 2), "bf16"), lib_ms, "SDPA",
        f"1 x {h} heads ({hkv} kv) x 1024 tokens x 128 bf16, causal")


def check_paged_prefill_d128(torch, dev, gen, flush, form) -> dict:
    """#4 at d 128 on the tensor-core body (bf16 chunk K/V and values): a
    256-token chunk over a fragmented 8-page prefix (start 1024), and a
    77-token ragged chunk at start 384 with the value page at ``start``
    and the chunk rows past ``chunk_len`` NaN-poisoned, dead entries on a
    NaN scratch page; 1e-4 against the plain version."""
    from repro_torch.kernels import paged_prefill as ppk
    hkv, qh = _d128_shape(form)
    d, pp = D128, 65
    p, scratch, qt = d // 2, pp - 1, qh * TC
    codes, stats = _d128_stats(torch, dev, gen, pp, hkv, p)
    vals = torch.randn((pp, hkv, G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    for x in (*stats, vals):
        x[scratch] = float("nan")
    perm = torch.randperm(scratch, generator=gen, device=dev)[:16].to(
        torch.int32)
    q = torch.randn((hkv, qt, d), generator=gen, device=dev) * d ** -0.5
    errs = []
    for start, clen in ((1024, TC), (384, 77)):
        n_live = -(-(start + clen) // G)
        width = 1 << (n_live - 1).bit_length()
        row = perm[:width].clone()
        row[n_live:] = scratch
        v = vals.clone()
        v[int(row[start // G])] = float("nan")
        kc, vc = (torch.randn((hkv, TC, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        kc[:, clen:] = float("nan")
        vc[:, clen:] = float("nan")
        n_mma = ppk.launches_mma
        got = ppk.polar_paged_prefill_grouped(q, kc, vc, codes, *stats, v,
                                              row, start, clen)
        assert ppk.launches_mma == n_mma + 1, "d 128 off the tensor cores"
        ref = ppk.polar_paged_prefill_grouped_plain(q, kc, vc, codes, *stats,
                                                    v, row, start, clen)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "NaN leaked into prefill"
        torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
        errs.append(float((got - ref).abs().max()))
    start, n = 1024, 8
    row = perm[:n].contiguous()
    kc, vc = (torch.randn((hkv, TC, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    args = (q, kc, vc, codes, *stats, vals, row, start, TC)
    ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped(*args),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: ppk.polar_paged_prefill_grouped_plain(
        *args), iters=5, flush=flush, lead_cycles=PLAIN_LEAD)
    rl = row.long()
    k_pre = _paged_keys(torch, codes, stats, rl[None])[0]
    v_pre = vals[rl].transpose(0, 1).reshape(hkv, start, d).float()
    k_all = torch.cat([k_pre, kc.float()], 1).repeat_interleave(qh, 0)
    v_all = torch.cat([v_pre, vc.float()], 1).repeat_interleave(qh, 0)
    i = torch.arange(TC, device=dev)
    mask = torch.cat([torch.ones((TC, start), dtype=torch.bool, device=dev),
                      i[:, None] >= i[None, :]], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q_h = q.reshape(hkv * qh, TC, d)[None]
    lib_ms = time_ms(torch, lambda: sdpa(q_h, k_all[None], v_all[None],
                                         attn_mask=mask, scale=1.0),
                     flush=flush)
    # the work of check_paged_prefill's bound at these heads and widths
    nbytes = (hkv * n * (G * p + 4 * p * 4 + G * d * 2) + n * 4
              + q.numel() * 4 + 2 * hkv * TC * d * 2 + hkv * qt * d * 4)
    pairs = hkv * (qt * start + qh * TC * (TC + 1) // 2)
    ops = {"bf16": 4.0 * d * pairs,
           "fp32": hkv * n * (4 * p * 16 + 4 * G * p) + 4.0 * pairs}
    return _form_row(
        "paged_prefill", form, "paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:136", max(errs), ms, plain_ms,
        bound(nbytes, ops), lib_ms,
        "SDPA over pre-dequantized keys (fp32, bool mask)",
        f"{hkv} kv heads x {qh} query heads x 256-token chunk over 8 prefix "
        "pages (1024 tokens) x d 128, bf16, tensor-core body")


def check_dense_d128(torch, dev, gen, flush, form) -> list[dict]:
    """#5 and #6 at d 128 on the static phase's dense buffers (8 rows x
    the form's kv heads x query heads (``D128_SHAPES``) x 9 groups, 8
    flushed): #5 on the split body with ragged lengths and every stat and
    value row past a length NaN-poisoned, #6 over every group; both
    within 1e-4 of the plain versions."""
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    from repro_torch.kernels.paged_decode import plan_splits
    hkv, qh = _d128_shape(form)
    plan = MESH_PLAN_HEADS.get(form)
    d = D128
    p = d // 2
    k = torch.randn((SB, hkv, 8 * G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    enc = pe.polar_encode(k)
    bufs = [torch.zeros((SB, hkv, SG, *x.shape[3:]), dtype=x.dtype,
                        device=dev) for x in enc]
    for b, x in zip(bufs, enc):
        b[:, :, :8] = x
    vals = torch.randn((SB, hkv, SMAX, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((SB, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    lens = [1024, 900, 0, 128, 1, 513, 640, 1023]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    v = vals.clone()
    st = [x.clone() for x in bufs[1:]]
    for i, n in enumerate(lens):
        v[i, :, n:] = float("nan")
        for x in st:
            x[i, :, -(-n // G):] = float("nan")
    n_split = pak.launches_split
    got = pak.polar_decode_attention_grouped(q, bufs[0], *st, v, length,
                                             plan_heads=plan)
    assert pak.launches_split == n_split + 1, "d 128 left the split body"
    ref = pak.polar_decode_attention_grouped_plain(q, bufs[0], *st, v, length)
    err = _partials_err(torch, got, ref)[0]
    own = ""
    if plan:
        # the rank's heads are the first block of the model's: pad the
        # inputs to every head and run the whole model's call
        nb = plan // hkv

        def whole(x):
            return torch.cat([x] + [torch.zeros_like(x)] * (nb - 1), 1)
        wfull = pak.polar_decode_attention_grouped(
            whole(q), whole(bufs[0]), *(whole(x) for x in st), whole(v),
            length)
        assert all(torch.equal(a[:, :hkv], b) for a, b in zip(wfull, got)), \
            f"{form}: the shard's #5 differs from the whole call's heads"
    full = torch.full((SB,), 8 * G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
        q, *bufs, vals, full, plan_heads=plan), flush=flush)
    if plan:
        own_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
            q, *bufs, vals, full), flush=flush)
        own = (f" (nsplit {plan_splits(SB, plan, SG)}, planned for {plan} kv "
               "heads; bit-equal to those heads of the whole call; the "
               f"shard's own plan, nsplit {plan_splits(SB, hkv, SG)}, takes "
               f"{own_ms:.4f} ms)")
    plain_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped_plain(
        q, *bufs, vals, full), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    kf = _dequant(torch, bufs)
    mask = (torch.arange(SMAX, device=dev) < 8 * G)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(
        q.reshape(SB, hkv * qh, 1, d), kf.repeat_interleave(qh, 1),
        vals.float().repeat_interleave(qh, 1), attn_mask=mask, scale=1.0),
        flush=flush)

    def flops(groups, attention):
        per = 3 * qh * p * 16 + 2 * G * p + 2 * qh * G * p
        return groups * (per + (4 * qh * G + 2 * qh * G * d
                                if attention else 0))
    groups = SB * hkv * 8
    nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4 + G * d * 2) \
        + SB * 4 + SB * hkv * qh * (d + 2) * 4
    rows = [_form_row(
        "polar_attention", form, "polar_attention.cu",
        "src/repro/kernels/polar_attention.py:104", err, ms, plain_ms,
        bound(nbytes, flops(groups, True), "fp32"), lib_ms,
        "SDPA over pre-dequantized keys (fp32, length mask)",
        f"8 rows x {hkv} kv heads x {qh} query heads x 8 flushed groups of a "
        "1152-token buffer x d 128, bf16 values" + own)]
    got = qkk.polar_qk_scores(q, *bufs)
    ref = qkk.polar_qk_scores_plain(q, *bufs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
    err = float((got - ref).abs().max())
    ms = time_ms(torch, lambda: qkk.polar_qk_scores(q, *bufs), flush=flush)
    plain_ms = time_ms(torch, lambda: qkk.polar_qk_scores_plain(q, *bufs),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    kt = kf.transpose(-1, -2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.matmul(q, kt), flush=flush)
    groups = SB * hkv * SG
    nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4) \
        + SB * hkv * qh * SMAX * 4
    rows.append(_form_row(
        "polar_qk", form, "polar_qk.cu", "src/repro/kernels/polar_qk.py:68",
        err, ms, plain_ms, bound(nbytes, flops(groups, False), "fp32"),
        lib_ms, "matmul over pre-dequantized keys (fp32)",
        f"8 rows x {hkv} kv heads x {qh} query heads x 9 groups (1152 "
        "tokens) x d 128"))
    return rows


def check_d128(torch, dev, gen, flush) -> list[dict]:
    """Every kernel at the paper's widths: #1-#6 at llama3.1-8b's (rows
    ``name[d128]``), #2-#6 also at qwen1.5-4b's 20 kv heads of one query
    head (``name[d128,qh1]``) and at dbrx-132b's 8 kv heads of six query
    heads (``name[d128,qh6]``). Their launches are counted in the configs
    and moe phases (:func:`d128_counts`)."""
    return [check_encode_d128(torch, dev, gen, flush),
            *(check_decode_d128(torch, dev, gen, flush, f)
              for f in D128_SHAPES),
            *(check_prefill_d128(torch, dev, gen, flush, f)
              for f in D128_SHAPES),
            *(check_paged_prefill_d128(torch, dev, gen, flush, f)
              for f in D128_SHAPES),
            *(row for f in D128_SHAPES
              for row in check_dense_d128(torch, dev, gen, flush, f)),
            *check_mesh_d128(torch, dev, gen, flush)]


def check_mesh_d128(torch, dev, gen, flush) -> list[dict]:
    """#1-#6 at a mesh rank's shapes (:data:`MESH_SHAPES`: llama3.1-8b's
    8 kv heads over two ranks, 4 a rank with 4 query heads each) — the
    kernels of the head-sharded paged path (#1-#4) and of the static
    engine's head-sharded linear caches (#1, #3, #5, #6; #2 and #5 plan
    their splits for the model's 8 kv heads). Their launches are counted
    in the mesh phase."""
    return [row for f in MESH_SHAPES for row in (
        check_encode_d128(torch, dev, gen, flush, f),
        check_decode_d128(torch, dev, gen, flush, f),
        check_prefill_d128(torch, dev, gen, flush, f),
        check_paged_prefill_d128(torch, dev, gen, flush, f),
        *check_dense_d128(torch, dev, gen, flush, f))]


# ---------------------------------------------------------------------------

#: head_dim 256 at one kv head: paligemma-3b's 8 query heads, 256 image
#: tokens + 744 text tokens (the families phase's 1000-token prompts, a
#: 1152-token dense buffer), and recurrentgemma-9b's 16 over its 2048-slot
#: ring (16 groups), 2560-token prompts under the 2048-token window
D256, VLM_QH, HYB_QH, PREFIX, WINDOW, HYB_T = 256, 8, 16, 256, 2048, 2560


def check_encode_d256(torch, dev, gen, flush) -> dict:
    """#1's dense form at the static prefill of both families: 8 rows x 1
    kv head x 7 groups x d 256 bf16 (P = 128 pairs); codes and stats
    bit-equal to the plain version."""
    from repro_torch.kernels import polar_encode as pe
    p = D256 // 2
    k = torch.randn((SB, 1, 7 * G, D256), generator=gen, device=dev).to(
        torch.bfloat16)
    k[0, 0, :5, :3] = 0.0
    got = pe.polar_encode(k)
    ref = pe.polar_encode_plain(k)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    assert err == 0.0, f"encode at d 256 differs from the plain version {err}"
    ms = time_ms(torch, lambda: pe.polar_encode(k), flush=flush)
    plain_ms = time_ms(torch, lambda: pe.polar_encode_plain(k), iters=10,
                       flush=flush, lead_cycles=PLAIN_LEAD)
    tokens = SB * 7 * G
    nbytes = tokens * (D256 * 2 + p) + 4 * SB * 7 * p * 4
    return _form_row(
        "polar_encode", "[d256]", "polar_encode.cu",
        "src/repro/kernels/polar_encode.py:51", err, ms, plain_ms,
        bound(nbytes, 22 * tokens * p, "fp32"), None, None,
        "dense form, 8 rows x 1 kv head x 896 tokens x 256 bf16 "
        "(launches: both forms)")


def check_prefill_d256(torch, dev, gen, flush, mode) -> dict:
    """#3 at d 256, bf16, 8 rows: ``prefix`` at paligemma-3b's 8 heads
    over 1 kv head, 1000 tokens, bidirectional over the first 256 (with
    other prefixes per row for the check: 0, mid-tile, past T), and
    ``local`` at recurrentgemma-9b's 16 over 1, 2560 tokens under a 2048
    window; within one bf16 step (2^-7) of the plain version. Timed at
    the served masks, beside SDPA with the same boolean mask."""
    from repro_torch.kernels import flash_prefill as fpk
    h, t = (VLM_QH, SPROMPT) if mode == "prefix" else (HYB_QH, HYB_T)
    q = torch.randn((SB, h, t, D256), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((SB, 1, t, D256), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    kw = ({"prefix_len": torch.full((SB,), PREFIX, dtype=torch.int32,
                                    device=dev)}
          if mode == "prefix" else {"window": WINDOW})
    checks = [kw]
    if mode == "prefix":
        checks.append({"prefix_len": torch.tensor(
            [0, 1, 100, 256, 257, 640, 999, 1500], dtype=torch.int32,
            device=dev)})
    errs = []
    for c in checks:
        got = fpk.flash_prefill(q, k, v, mode=mode, **c)
        ref = fpk.flash_prefill_plain(q, k, v, mode=mode, **c)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL)
        errs.append(float((got.float() - ref.float()).abs().max()))
        del ref
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v, mode=mode, **kw),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(
        q, k, v, mode=mode, **kw), iters=5, flush=flush,
        lead_cycles=PLAIN_LEAD)
    i = torch.arange(t, device=dev)
    causal = i[:, None] >= i[None, :]
    mask = (causal | (i[None, :] < PREFIX) if mode == "prefix"
            else causal & (i[:, None] - i[None, :] < WINDOW))
    ke, ve = (x.repeat_interleave(h, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q, ke, ve, attn_mask=mask),
                     flush=flush)
    pairs = SB * float(mask.sum())
    return _form_row(
        "flash_prefill", f"[d256,{mode}]", "flash_prefill.cu",
        "src/repro/kernels/flash_prefill.py:77", max(errs), ms, plain_ms,
        bound(SB * (2 * h + 2) * t * D256 * 2, 4.0 * h * D256 * pairs,
              "bf16"), lib_ms, "SDPA, bool mask",
        f"8 x {h} heads (1 kv) x {t} tokens x 256 bf16, " + (
            f"prefix {PREFIX}" if mode == "prefix" else f"window {WINDOW}"))


def check_dense_d256(torch, dev, gen, flush) -> list[dict]:
    """#5 at paligemma-3b's decode shape (8 rows x 1 kv head x 8 query
    heads x 9 groups of a 1152-token buffer, 8 flushed, d 256, bf16
    values) on the split body with one staging buffer, ragged lengths and
    NaN-poisoned rows past them; #6 at the same buffer (``[d256,qh8]``)
    and at recurrentgemma-9b's 16 query heads over its 2048-slot ring
    (``[d256,qh16]``); all within 1e-4 of the plain versions."""
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    d, p = D256, D256 // 2

    def buffers(groups, flushed):
        k = torch.randn((SB, 1, flushed * G, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        enc = pe.polar_encode(k)
        bufs = [torch.zeros((SB, 1, groups, *x.shape[3:]), dtype=x.dtype,
                            device=dev) for x in enc]
        for b, x in zip(bufs, enc):
            b[:, :, :flushed] = x
        return bufs

    def flops(groups, qh, attention):
        per = 3 * qh * p * 16 + 2 * G * p + 2 * qh * G * p
        return groups * (per + (4 * qh * G + 2 * qh * G * d
                                if attention else 0))

    bufs = buffers(SG, 8)
    vals = torch.randn((SB, 1, SMAX, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((SB, 1, VLM_QH, d), generator=gen, device=dev) * d ** -0.5
    lens = [1024, 900, 0, 128, 1, 513, 640, 1023]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    v = vals.clone()
    st = [x.clone() for x in bufs[1:]]
    for i, n in enumerate(lens):
        v[i, :, n:] = float("nan")
        for x in st:
            x[i, :, -(-n // G):] = float("nan")
    n_split = pak.launches_split
    got = pak.polar_decode_attention_grouped(q, bufs[0], *st, v, length)
    assert pak.launches_split == n_split + 1, "d 256 left the split body"
    ref = pak.polar_decode_attention_grouped_plain(q, bufs[0], *st, v, length)
    err = _partials_err(torch, got, ref)[0]
    full = torch.full((SB,), 8 * G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
        q, *bufs, vals, full), flush=flush)
    plain_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped_plain(
        q, *bufs, vals, full), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    kr = _dequant(torch, bufs).repeat_interleave(VLM_QH, 1)
    vr = vals.float().repeat_interleave(VLM_QH, 1)
    qr = q.reshape(SB, VLM_QH, 1, d)
    mask = (torch.arange(SMAX, device=dev) < 8 * G)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qr, kr, vr, attn_mask=mask,
                                         scale=1.0), flush=flush)
    groups = SB * 8
    nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4 + G * d * 2) \
        + SB * 4 + SB * VLM_QH * (d + 2) * 4
    rows = [_form_row(
        "polar_attention", f"[d256,qh{VLM_QH}]", "polar_attention.cu",
        "src/repro/kernels/polar_attention.py:104", err, ms, plain_ms,
        bound(nbytes, flops(groups, VLM_QH, True), "fp32"), lib_ms,
        "SDPA over pre-dequantized keys (fp32, length mask)",
        "8 rows x 1 kv head x 8 query heads x 8 flushed groups of a "
        "1152-token buffer x d 256, bf16 values, one staging buffer")]
    ring = WINDOW // G
    for qh, gcount, b in ((VLM_QH, SG, bufs),
                          (HYB_QH, ring, buffers(ring, ring))):
        q = torch.randn((SB, 1, qh, d), generator=gen, device=dev) \
            * d ** -0.5
        got = qkk.polar_qk_scores(q, *b)
        ref = qkk.polar_qk_scores_plain(q, *b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
        err = float((got - ref).abs().max())
        ms = time_ms(torch, lambda: qkk.polar_qk_scores(q, *b), flush=flush)
        plain_ms = time_ms(torch, lambda: qkk.polar_qk_scores_plain(q, *b),
                           iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
        kt = _dequant(torch, b).transpose(-1, -2).contiguous()
        lib_ms = time_ms(torch, lambda: torch.matmul(q, kt), flush=flush)
        groups = SB * gcount
        nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4) \
            + SB * qh * gcount * G * 4
        rows.append(_form_row(
            "polar_qk", f"[d256,qh{qh}]", "polar_qk.cu",
            "src/repro/kernels/polar_qk.py:68", err, ms, plain_ms,
            bound(nbytes, flops(groups, qh, False), "fp32"), lib_ms,
            "matmul over pre-dequantized keys (fp32)",
            f"8 rows x 1 kv head x {qh} query heads x {gcount} groups "
            f"({gcount * G} tokens) x d 256"))
    return rows


def check_d256(torch, dev, gen, flush) -> list[dict]:
    """The head_dim-256 forms of the families phase: #1 (``[d256]``), #3
    in ``prefix`` and ``local`` modes, #5 at 8 query heads per kv head and
    #6 at 8 and 16. Their launches are counted in the families phase
    (:func:`family_rows`)."""
    return [check_encode_d256(torch, dev, gen, flush),
            *(check_prefill_d256(torch, dev, gen, flush, m)
              for m in ("prefix", "local")),
            *check_dense_d256(torch, dev, gen, flush)]


# ---------------------------------------------------------------------------

#: seamless-m4t-medium (the families phase's encoder-decoder): 8 rows, 16
#: kv heads of one query head each (MHA) at head_dim 64, 1024 stubbed audio
#: frames, a 16-token decoder prompt, a 256-token self cache (2 groups)
ED_HKV, ED_FRAMES, ED_TEXT, ED_NEW, ED_MAX = 16, 1024, 16, 128, 256


def check_encode_d64(torch, dev, gen, flush) -> dict:
    """#1's dense form at the cross-cache fill: 8 rows x 16 kv heads x 1024
    un-rotated memory keys x d 64 bf16 (8 groups each); codes and stats
    bit-equal to the plain version."""
    from repro_torch.kernels import polar_encode as pe
    p = D // 2
    k = torch.randn((SB, ED_HKV, ED_FRAMES, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    k[0, 0, :5, :3] = 0.0
    got = pe.polar_encode(k)
    ref = pe.polar_encode_plain(k)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    assert err == 0.0, f"encode at the cross fill differs {err}"
    ms = time_ms(torch, lambda: pe.polar_encode(k), flush=flush)
    plain_ms = time_ms(torch, lambda: pe.polar_encode_plain(k), iters=10,
                       flush=flush, lead_cycles=PLAIN_LEAD)
    tokens = SB * ED_HKV * ED_FRAMES
    nbytes = tokens * (D * 2 + p) + 4 * (tokens // G) * p * 4
    return _form_row(
        "polar_encode", "[d64,cross]", "polar_encode.cu",
        "src/repro/kernels/polar_encode.py:51", err, ms, plain_ms,
        bound(nbytes, 22 * tokens * p, "fp32"), None, None,
        "dense form, 8 rows x 16 kv heads x 1024 memory keys x 64 bf16 "
        "(the cross-cache fill)")


def check_prefill_d64(torch, dev, gen, flush, form) -> dict:
    """#3 at d 64, bf16, 8 rows x 16 heads over 16 kv heads, within one
    bf16 step (2^-7) of the plain version: ``[d64,full]`` the encoder's
    full mode over 1024 x 1024 frames; ``[d64,cross]`` full mode at Tq 16
    over Tk 1024 memory frames, also checked at a ragged Tq 33 / Tk 1000
    (key-tile masking past Tk, zero-filled q rows past Tq); ``[d64,qh1]``
    the decoder prompt's causal 16 x 16. Timed beside SDPA."""
    from repro_torch.kernels import flash_prefill as fpk
    mode = "causal" if form == "[d64,qh1]" else "full"
    shapes = {"[d64,full]": [(ED_FRAMES, ED_FRAMES)],
              "[d64,cross]": [(ED_TEXT, ED_FRAMES), (33, 1000)],
              "[d64,qh1]": [(ED_TEXT, ED_TEXT)]}[form]
    h = ED_HKV
    errs = []
    for tq, tk in reversed(shapes):
        q = torch.randn((SB, h, tq, D), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((SB, h, tk, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        got = fpk.flash_prefill(q, k, v, mode=mode)
        ref = fpk.flash_prefill_plain(q, k, v, mode=mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL)
        errs.append(float((got.float() - ref.float()).abs().max()))
        del ref
    tq, tk = shapes[0]
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v, mode=mode),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(
        q, k, v, mode=mode), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=mode == "causal"),
                     flush=flush)
    pairs = SB * (tq * (tq + 1) / 2 if mode == "causal" else tq * tk)
    return _form_row(
        "flash_prefill", form, "flash_prefill.cu",
        "src/repro/kernels/flash_prefill.py:77", max(errs), ms, plain_ms,
        bound(SB * h * (2 * tq + 2 * tk) * D * 2, 4.0 * h * D * pairs,
              "bf16"), lib_ms, "SDPA",
        f"8 x 16 heads (16 kv) x {tq} queries x {tk} keys x 64 bf16, "
        f"{mode}" + (", also Tq 33 / Tk 1000" if len(shapes) > 1 else ""))


def check_dense_d64(torch, dev, gen, flush) -> list[dict]:
    """#5 at seamless-m4t-medium's self decode (8 rows x 16 kv heads x 1
    query head over a 256-token buffer of 2 groups, the first flushed,
    d 64, bf16 values, ragged lengths with the rows past them
    NaN-poisoned) on the split body, and #6 at its cross decode (8 rows x
    16 kv heads x 1 query head x 8 groups, the 1024 memory keys); both
    within 1e-4 of the plain versions."""
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    hkv, qh, d, p = ED_HKV, 1, D, D // 2

    def buffers(groups, flushed):
        k = torch.randn((SB, hkv, flushed * G, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        enc = pe.polar_encode(k)
        bufs = [torch.zeros((SB, hkv, groups, *x.shape[3:]), dtype=x.dtype,
                            device=dev) for x in enc]
        for b, x in zip(bufs, enc):
            b[:, :, :flushed] = x
        return bufs

    def flops(groups, attention):
        per = 3 * qh * p * 16 + 2 * G * p + 2 * qh * G * p
        return groups * (per + (4 * qh * G + 2 * qh * G * d
                                if attention else 0))

    sg = ED_MAX // G
    bufs = buffers(sg, 1)
    vals = torch.randn((SB, hkv, ED_MAX, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((SB, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    lens = [128, 100, 0, 1, 64, 127, 128, 37]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    v = vals.clone()
    st = [x.clone() for x in bufs[1:]]
    for i, n in enumerate(lens):
        v[i, :, n:] = float("nan")
        for x in st:
            x[i, :, -(-n // G):] = float("nan")
    n_split = pak.launches_split
    got = pak.polar_decode_attention_grouped(q, bufs[0], *st, v, length)
    assert pak.launches_split == n_split + 1, "d 64 qh 1 left the split body"
    ref = pak.polar_decode_attention_grouped_plain(q, bufs[0], *st, v, length)
    err = _partials_err(torch, got, ref)[0]
    full = torch.full((SB,), G, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped(
        q, *bufs, vals, full), flush=flush)
    plain_ms = time_ms(torch, lambda: pak.polar_decode_attention_grouped_plain(
        q, *bufs, vals, full), iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    mask = (torch.arange(ED_MAX, device=dev) < G)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kf = _dequant(torch, bufs)
    lib_ms = time_ms(torch, lambda: sdpa(
        q.reshape(SB, hkv, 1, d), kf, vals.float(), attn_mask=mask,
        scale=1.0), flush=flush)
    groups = SB * hkv
    nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4 + G * d * 2) \
        + SB * 4 + SB * hkv * qh * (d + 2) * 4
    rows = [_form_row(
        "polar_attention", "[d64,qh1]", "polar_attention.cu",
        "src/repro/kernels/polar_attention.py:104", err, ms, plain_ms,
        bound(nbytes, flops(groups, True), "fp32"), lib_ms,
        "SDPA over pre-dequantized keys (fp32, length mask)",
        "8 rows x 16 kv heads x 1 query head x 1 flushed group of a "
        "256-token buffer x d 64, bf16 values")]
    cg = ED_FRAMES // G
    cross = buffers(cg, cg)
    got = qkk.polar_qk_scores(q, *cross)
    ref = qkk.polar_qk_scores_plain(q, *cross)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
    err = float((got - ref).abs().max())
    ms = time_ms(torch, lambda: qkk.polar_qk_scores(q, *cross), flush=flush)
    plain_ms = time_ms(torch, lambda: qkk.polar_qk_scores_plain(q, *cross),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    kt = _dequant(torch, cross).transpose(-1, -2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.matmul(q, kt), flush=flush)
    groups = SB * hkv * cg
    nbytes = q.numel() * 4 + groups * (G * p + 4 * p * 4) \
        + SB * hkv * qh * ED_FRAMES * 4
    rows.append(_form_row(
        "polar_qk", "[d64,qh1]", "polar_qk.cu",
        "src/repro/kernels/polar_qk.py:68", err, ms, plain_ms,
        bound(nbytes, flops(groups, False), "fp32"), lib_ms,
        "matmul over pre-dequantized keys (fp32)",
        "8 rows x 16 kv heads x 1 query head x 8 groups (the 1024-frame "
        "cross cache) x d 64"))
    return rows


def check_d64(torch, dev, gen, flush) -> list[dict]:
    """The encoder-decoder's forms at head_dim 64 with 16 kv heads of one
    query head: #1 at the cross-cache fill, #3 in ``full`` mode (encoder
    and cross-attention) and causal (the decoder prompt), #5 at the self
    decode and #6 at the cross decode. Their launches are counted in the
    families phase (:func:`encdec_run`)."""
    return [check_encode_d64(torch, dev, gen, flush),
            *(check_prefill_d64(torch, dev, gen, flush, f)
              for f in ("[d64,full]", "[d64,cross]", "[d64,qh1]")),
            *check_dense_d64(torch, dev, gen, flush)]


def phase_kernels(torch) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = [*check_encode(torch, dev, gen, flush),
            check_decode(torch, dev, gen, flush),
            check_prefill(torch, dev, gen, flush),
            check_paged_prefill(torch, dev, gen, flush),
            check_polar_attention(torch, dev, gen, flush),
            check_qk_scores(torch, dev, gen, flush),
            check_decode_u8(torch, dev, gen, flush),
            check_paged_prefill_u8(torch, dev, gen, flush),
            check_polar_attention_u8(torch, dev, gen, flush),
            *check_d128(torch, dev, gen, flush),
            *check_d256(torch, dev, gen, flush),
            *check_d64(torch, dev, gen, flush)]
    backends_err = max(check_paged_backends(torch, dev, gen, vb)
                       for vb in (0, 4))
    print("kernels: " + "; ".join(
        f"{r['name']} err {r['max_abs_err']:.3g}"
        + (f" (partials {r['partials_err']:.3g})" if "partials_err" in r
           else "") + f" {r['ms']:.4f} ms "
        + (f"(the shard's own plan {r['own_plan_ms']:.4f} ms) "
           if "own_plan_ms" in r else "")
        + f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"{r['bound_by']}" + (f", {r.get('library', 'library')} "
                              f"{r['library_ms']:.4f} ms"
                              if r["library_ms"] is not None else "") + ")"
        for r in rows), flush=True)
    print(f"paged backends: jnp, gathered and paged_fused agree to "
          f"{backends_err:.3g} (limit {FP32_TOL}) on fragmented 8-slot "
          "caches with a NaN scratch page, bf16 and 4-bit values",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# --variants: the alternatives the two redesigned kernels were chosen against
# ---------------------------------------------------------------------------


def _qk_groups_per_block(ng: int) -> tuple:
    """polar_qk with blocks that own ``ng`` groups of one (row, kv head)
    and stage q once for all of them."""
    q_stage = ("  for (int i = tid; i < Qh * d; i += kThreads) "
               "q_s[i] = q[bh * Qh * d + i];\n")
    return (("const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;",
             "const int h = blockIdx.y, b = blockIdx.z;"),
            ("  const long long grp = bh * G + n;\n", ""),
            (q_stage, ""),
            ("  uint4 cr[kWords];\n",
             q_stage + f"  for (int n = blockIdx.x * {ng}; "
             f"n < min(G, (blockIdx.x + 1) * {ng}); ++n) {{\n"
             "  const long long grp = bh * G + n;\n  __syncthreads();\n"
             "  uint4 cr[kWords];\n"),
            ("  }\n}\n\ntemplate <int kP, int kTB>\nint launch(",
             "  }\n}\n}\n\ntemplate <int kP, int kTB>\nint launch("),
            ("const dim3 grid(G, Hkv, B);",
             f"const dim3 grid((G + {ng - 1}) / {ng}, Hkv, B);"))


_PER_SPLIT = ("const int per_split = N > 0 && nsplit > 0 ? (N + nsplit - 1) / "
              "nsplit : 1;")
_TWO_PAGES = (_PER_SPLIT, "const int per_split = N > 0 && nsplit > 0 ? "
              "max(2, (N + nsplit - 1) / nsplit) : 1;")

# (kernel, variant, literal replacements, each made in the one file of the
# kernel's source and the shared csrc/*.cuh headers that holds it once)
VARIANTS = (
    ("flash_prefill", "__launch_bounds__(128, 1)",
     (("__launch_bounds__(kMmaThreads, D <= 128 ? 2 : 1)",
       "__launch_bounds__(kMmaThreads)"),)),
    ("flash_prefill", "exp2f for ex2.approx.ftz",
     ((r'asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));',
       "y = exp2f(x);"),)),
    ("polar_qk", "3 groups per block", _qk_groups_per_block(3)),
    ("polar_qk", "9 groups per block", _qk_groups_per_block(9)),
    ("paged_decode", "2 pages per split", (_TWO_PAGES,)),
    ("paged_decode", "2 pages per split, single-buffered",
     (_TWO_PAGES, ("constexpr int kSplitStages = 2;",
                   "constexpr int kSplitStages = 1;"))),
    ("paged_decode", "one split per (slot, kv head)",
     ((_PER_SPLIT, "const int per_split = N > 0 ? N : 1;"),)),
    ("paged_prefill", "one key group (4 warps, 64-key chunk stages)",
     (("constexpr int kKeyGroups = 2;", "constexpr int kKeyGroups = 1;"),)),
    ("polar_attention", "the unsplit body (one block per row and kv head)",
     (("const bool split = rt::lut_split_decode_fits(",
       "const bool split = false && rt::lut_split_decode_fits("),)),
    ("polar_encode", "cluster of 1 (one block per group)",
     (("constexpr int kCluster = 4;", "constexpr int kCluster = 1;"),)),
    ("polar_encode", "cluster of 2",
     (("constexpr int kCluster = 4;", "constexpr int kCluster = 2;"),)),
    ("polar_encode", "cluster of 8",
     (("constexpr int kCluster = 4;", "constexpr int kCluster = 8;"),)),
    ("polar_encode", "8 pairs a thread (16-byte bf16 loads, half the threads)",
     (("constexpr int kVec = 4;", "constexpr int kVec = 8;"),)),
    ("polar_encode", "2 pairs a thread (twice the threads)",
     (("constexpr int kVec = 4;", "constexpr int kVec = 2;"),
      ("constexpr int kWideThreads = 256;",
       "constexpr int kWideThreads = 512;"))),
    ("polar_encode", "last cluster barrier split: arrive after the peers' "
     "reads, wait before exit",
     (("    red[i] = x;\n  }\n  __syncthreads();",
       "    red[i] = x;\n  }\n  asm volatile(\"barrier.cluster.arrive."
       "relaxed.aligned;\\n\" ::: \"memory\");\n  __syncthreads();"),
      ("  // no block leaves while a peer may still read its rows\n"
       "  cluster.sync();",
       "  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: "
       "\"memory\");"))),
)


def _prefill_inputs(torch, dev, gen, start):
    """Arguments of ``paged_prefill.polar_paged_prefill_grouped`` at the
    main path's shape: a full bf16 256-token chunk over ``start / g``
    prefix pages of a 65-page pool, bf16 values."""
    pp = 65
    codes = torch.randint(0, 256, (pp, HKV, G, P), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    stats = [lo + (hi - lo) * torch.rand((pp, HKV, 1, P), generator=gen,
                                         device=dev)
             for lo, hi in ((0.01, 0.3), (0.0, 1.0), (0.05, 0.4), (0.0, 0.5))]
    vals = torch.randn((pp, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((HKV, QH * TC, D), generator=gen, device=dev) * D ** -0.5
    kc, vc = (torch.randn((HKV, TC, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    row = torch.randperm(pp - 1, generator=gen, device=dev)[:start // G].to(
        torch.int32)
    return (q, kc, vc, codes, *stats, vals, row, start, TC)


def _decode_inputs(torch, dev, gen, s, n):
    """Arguments of ``paged_decode.polar_paged_decode_grouped`` with every
    slot at ``n`` live pages of a 65-page pool, bf16 values."""
    pp = 65
    codes = torch.randint(0, 256, (pp, HKV, G, P), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    stats = [lo + (hi - lo) * torch.rand((pp, HKV, 1, P), generator=gen,
                                         device=dev)
             for lo, hi in ((0.01, 0.3), (0.0, 1.0), (0.05, 0.4), (0.0, 0.5))]
    vals = torch.randn((pp, HKV, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((s, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    table = torch.randperm(pp - 1, generator=gen, device=dev)[:s * n] \
        .reshape(s, n).to(torch.int32)
    fl = torch.full((s,), n * G, dtype=torch.int32, device=dev)
    return (q, codes, *stats, vals, table, fl)


def _variant_sources() -> list[tuple[str, str, dict]]:
    """(kernel, label, {file name: text}) of each variant: ``VARIANTS``'
    edits of the current sources (the kernel's ``.cu`` and every shared
    ``.cuh``)."""
    from repro_torch.kernels import _build
    out = []
    for name, label, edits in VARIANTS:
        srcs = {f.name: f.read_text() for f in
                (_build.CSRC / f"{name}.cu", *_build.CSRC.glob("*.cuh"))}
        for old, new in edits:
            hits = [f for f, t in srcs.items() if t.count(old)]
            assert len(hits) == 1 and srcs[hits[0]].count(old) == 1, \
                f"{label}: {old!r} not found once"
            srcs[hits[0]] = srcs[hits[0]].replace(old, new)
        out.append((name, label, srcs))
    return out


def phase_variants(torch) -> None:
    """Builds each variant of :func:`_variant_sources` (one parallel
    ``nvcc`` each), checks it against the current source and times both at
    the kernel checks' main-path shapes, in the order current, variant,
    variant, current."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as ppk
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    mods = {"flash_prefill": fpk, "polar_qk": qkk, "paged_decode": pd,
            "paged_prefill": ppk, "polar_attention": pak,
            "polar_encode": pe}
    _build.build(tuple(mods))
    variants = _variant_sources()
    procs = []
    for i, (name, label, srcs) in enumerate(variants):
        # quoted includes resolve in the copy's own directory first
        vd = _build.BUILD_DIR / "variants" / str(i)
        vd.mkdir(parents=True, exist_ok=True)
        for f, t in srcs.items():
            (vd / f).write_text(t)
        cu = vd / f"{name}.cu"
        procs.append(subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    for proc, (_, label, _) in zip(procs, variants):
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{label} does not build:\n{log}"
        logs.append(log)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def qkv(b, t):
        return [torch.randn((b, hh, t, D), generator=gen, device=dev).to(
            torch.bfloat16) for hh in (32, HKV, HKV)]
    x1, x8 = qkv(1, 1024), qkv(SB, SPROMPT)
    bufs, _ = _dense_cache(torch, dev, gen)
    q = torch.randn((SB, HKV, QH, D), generator=gen, device=dev) * D ** -0.5
    d8, d1 = (_decode_inputs(torch, dev, gen, s, n)
              for s, n in ((8, 8), (1, 32)))
    p1, p2 = (_prefill_inputs(torch, dev, gen, st) for st in (1024, 2048))
    length = torch.full((SB,), 8 * G, dtype=torch.int32, device=dev)
    vals = torch.randn((SB, HKV, SMAX, D), generator=gen, device=dev).to(
        torch.bfloat16)
    vc, vs, vz = _u8_values(torch, dev, gen, (SB, HKV, SMAX, D), 4)
    ek, epages, eres, eforms = _encode_inputs(torch, dev, gen)
    epools = _encode_pools(torch, dev)

    def encode(k, pages):
        pe.polar_encode_pages(k, pages, *epools)
        return epools

    calls = {"flash_prefill": {
                 "1 x 32 heads x 1024 x 64 bf16": lambda: fpk.flash_prefill(*x1),
                 f"{SB} x 32 heads x {SPROMPT} x 64 bf16":
                     lambda: fpk.flash_prefill(*x8)},
             "polar_qk": {"8 rows x 4 kv heads x 8 query heads x 9 groups":
                          lambda: qkk.polar_qk_scores(q, *bufs)},
             "paged_decode": {
                 "8 slots x 4 kv heads x 8 query heads x 8 pages, bf16":
                     lambda: pd.polar_paged_decode_grouped(*d8),
                 "1 slot x 4 kv heads x 8 query heads x 32 pages, bf16":
                     lambda: pd.polar_paged_decode_grouped(*d1)},
             "paged_prefill": {
                 "4 kv x 8 query heads x 256-token chunk, start 1024, bf16":
                     lambda: ppk.polar_paged_prefill_grouped(*p1),
                 "4 kv x 8 query heads x 256-token chunk, start 2048, bf16":
                     lambda: ppk.polar_paged_prefill_grouped(*p2)},
             "polar_attention": {
                 "8 rows x 4 kv heads x 8 query heads x 8 of 9 groups, bf16":
                     lambda: pak.polar_decode_attention_grouped(
                         q, *bufs, vals, length),
                 "8 rows x 4 kv heads x 8 query heads x 8 of 9 groups, "
                 "4-bit value codes":
                     lambda: pak.polar_decode_attention_grouped(
                         q, *bufs, vc, length, vscale=vs, vzero=vz)},
             "polar_encode": {
                 "prefill form, 4 kv heads x 1024 tokens, bf16":
                     lambda: encode(ek, epages),
                 **{f"decode form, 8 slots x 4 kv heads x 128 tokens, {lb}":
                    (lambda pg=pg: encode(eres, pg))
                    for lb, pg in eforms.items()}}}
    tol = {"flash_prefill": BF16_RTOL, "polar_qk": FP32_TOL,
           "paged_decode": FP32_TOL, "paged_prefill": FP32_TOL,
           "polar_attention": FP32_TOL, "polar_encode": 0.0}
    current = {n: _build.library(n, m._bind) for n, m in mods.items()}

    def tensors(x):
        # copies: the encode's outputs are pools that the next call rewrites
        return [t.float().clone()
                for t in (x if isinstance(x, tuple) else (x,))]

    def fresh():
        # zeroed pools before a checked encode, so that a page the variant
        # skips cannot pass on the current kernel's codes
        for x in epools:
            x.zero_()
    rows = []
    for i, (name, label, _) in enumerate(variants):
        lib = ctypes.CDLL(str(_build.BUILD_DIR / "variants" / str(i)
                              / f"{name}.so"))
        mods[name]._bind(lib)
        for shape, fn in calls[name].items():
            fresh()
            ref = tensors(fn())
            ts = []
            try:
                _build._LIBS[name] = lib
                fresh()
                for a, b in zip(tensors(fn()), ref):
                    torch.testing.assert_close(a, b, rtol=tol[name],
                                               atol=tol[name])
                for which in (current[name], lib, lib, current[name]):
                    _build._LIBS[name] = which
                    ts.append(time_ms(torch, fn, flush=flush))
            finally:
                _build._LIBS[name] = current[name]
            rows.append({"kernel": name, "variant": label, "shape": shape,
                         "current_ms": (ts[0] + ts[3]) / 2,
                         "variant_ms": (ts[1] + ts[2]) / 2,
                         "ptxas": ptxas_lines(logs[i])})
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, lambda: one.add_(1), flush=flush)
    for r in rows:
        print(f"variant: {r['kernel']} {r['variant']} at {r['shape']}: "
              f"{r['variant_ms']:.4f} ms, current {r['current_ms']:.4f} ms",
              flush=True)
    print(json.dumps({"variants": rows, "timing_floor_ms": floor_ms}),
          flush=True)


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernel path vs plain path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper of the model paths for its plain version
    (the reference runs of the model and static phases)."""
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as ppk
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    stack = mock.patch.multiple
    with stack(pe, polar_encode_pages=pe.polar_encode_pages_plain,
               polar_encode=pe.polar_encode_plain), \
            stack(pd, polar_paged_decode_grouped=
                  pd.polar_paged_decode_grouped_plain), \
            stack(ppk, polar_paged_prefill_grouped=
                  ppk.polar_paged_prefill_grouped_plain), \
            stack(fpk, flash_prefill=fpk.flash_prefill_plain), \
            stack(pak, polar_decode_attention_grouped=
                  pak.polar_decode_attention_grouped_plain), \
            stack(qkk, polar_qk_scores=qkk.polar_qk_scores_plain):
        yield


@contextlib.contextmanager
def record_routes(sink: list):
    """Append the expert indices (B, T, k) of every MoE layer's routing to
    ``sink`` while the block runs."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route

    def rec(params, x, cfg):
        out = route(params, x, cfg)
        sink.append(out[2])
        return out
    with mock.patch.object(moe_mod, "route", rec):
        yield


@contextlib.contextmanager
def replay_routes(recorded: list):
    """Route every MoE layer to the experts ``recorded`` by a kernel run's
    :func:`record_routes` (consumed in call order), with the gates from
    this run's own router probabilities. A plain run against a kernel run
    then compares the kernels' arithmetic with the routing held fixed:
    the choice of experts is discrete, and bf16 noise near tied router
    logits flips some of it, which moves a token's FFN output by a whole
    expert whatever the kernels' error."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route
    todo = list(recorded)

    def rep(params, x, cfg):
        probs, _, _ = route(params, x, cfg)
        eidx = todo.pop(0)
        assert eidx.shape == (*probs.shape[:-1], cfg.top_k), eidx.shape
        gates = probs.gather(-1, eidx)
        if cfg.norm_topk:
            gates = gates / gates.sum(dim=-1, keepdim=True)
        return probs, gates, eidx
    with mock.patch.object(moe_mod, "route", rep):
        yield
    assert not todo, f"{len(todo)} recorded routings not replayed"


def routing_flips(torch, a: list, b: list) -> float | None:
    """Share of routing decisions (one layer's top-k expert set for one
    token) that differ between two runs' :func:`record_routes`; None when
    no MoE layer ran."""
    assert len(a) == len(b)
    if not a:
        return None
    diff = [(x.sort(-1).values != y.sort(-1).values).any(-1).flatten()
            for x, y in zip(a, b)]
    return float(torch.cat(diff).float().mean())


def free_routing(torch, run, kern, routes: list) -> dict | None:
    """For an MoE model (``routes`` recorded while ``run`` gave ``kern``
    through the kernels), ``run`` again on the plain versions with its own
    routing: {"flips": the share of routing decisions it makes
    differently (:func:`routing_flips`), "free_rel": the relative L2
    logit error of ``kern`` against it per step (flattened), "agree": the
    argmax agreement}. Its median step must be within MODEL_REL_L2: a
    routing flip moves the few steps it reaches by a whole expert, a
    faulty kernel moves every step. None for a dense model."""
    if not routes:
        return None
    free_routes: list = []
    with plain_kernels(), record_routes(free_routes):
        free = run()
    rel = ((kern - free).norm(dim=-1) / free.norm(dim=-1)).flatten()
    out = {"flips": routing_flips(torch, routes, free_routes),
           "free_rel": rel,
           "agree": float((kern.argmax(-1) == free.argmax(-1)).float()
                          .mean())}
    assert float(rel.median()) <= MODEL_REL_L2, \
        f"logits drift under free routing {rel.tolist()}, {out['flips']}"
    return out


def paged_logit_gate(torch, model, params, t0=512, steps=16):
    """Per-step relative L2 error of the logits, kernels vs plain
    versions, of a ``t0``-token paged prefill and ``steps`` teacher-forced
    decode steps (one slot of 8 pages), and the argmax agreement. For an
    MoE model the gated plain run takes the kernel run's expert choices
    (:func:`replay_routes`), and a third run, plain with its own routing,
    is gated on its median step (:func:`free_routing`, returned as
    ``moe``); ``moe`` is None for a dense model."""
    from repro_torch.core.cache_layout import PagedLayout
    dev = params["embed"].device
    cfg = model.cfg
    rng = torch.Generator(device="cpu")
    rng.manual_seed(1)
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

    routes: list = []
    with record_routes(routes):
        kern = run()
    with plain_kernels(), replay_routes(routes):
        plain = run()
    rel = ((kern - plain).norm(dim=-1) / plain.norm(dim=-1)).flatten()
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    moe = free_routing(torch, run, kern, routes)
    assert torch.isfinite(kern).all()
    assert float(rel.max()) <= MODEL_REL_L2, \
        f"logits drift {rel.tolist()}; MoE routing replayed, free run {moe}"
    return rel, agree, moe


def phase_model(torch, model, params) -> None:
    t0, steps = 512, 16
    rel, agree, _ = paged_logit_gate(torch, model, params, t0, steps)
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


def serve_expect(launches: dict, cfg, out, prompt_lens) -> dict:
    """The exact launches of a classic paged serving run: flash prefill
    once a layer and prompt; per polar layer, a prefill encodes only when
    the prompt fills at least one group, and every decode step (each
    micro-step of a run-ahead horizon, frozen lanes included) launches the
    paged decode and the (masked) flush encode once."""
    nl, steps = cfg.num_layers, out["decode_steps"]
    npl = polar_layers(cfg)
    full = sum(int(t) >= G for t in prompt_lens)
    return {**dict.fromkeys(launches, 0),
            encode_name(cfg): npl * (full + steps),
            f"paged_decode{value_form(cfg)}": npl * steps,
            "flash_prefill": nl * out["prefills"]}


def rid_events(out) -> dict:
    """Each request's (kind, ordinal, token) sequence: what a client of the
    rid sees, whatever the order across requests (which follows the
    engine clock)."""
    by_rid: dict = {}
    for e in out["events"]:
        by_rid.setdefault(e.rid, []).append((e.kind, e.ordinal, e.token))
    return by_rid


def serve_line(out) -> str:
    """tok/s, TTFT and decode-step numbers of a serving run."""
    return (f"{out['total_tokens']} tokens in {out['wall_s']:.3f} s = "
            f"{out['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{out['p50_ttft_s'] * 1e3:.1f} ms p99 "
            f"{out['p99_ttft_s'] * 1e3:.1f} ms; decode "
            f"{out['decode_steps']} steps mean "
            f"{out['decode_step_s_mean'] * 1e3:.3f} ms p50 "
            f"{out['decode_step_s_p50'] * 1e3:.3f} ms; "
            f"{out['prefills']} prefills {out['prefill_s_total']:.3f} s; "
            f"mean active slots {out['mean_active_slots']:.2f}")


def phase_serve(torch, model, params, counters, n_req=16, new=64, seed=0,
                label="serve", eager_arm=True, gap=0.02) -> tuple:
    """``n_req`` greedy requests (prompts 100-900 tokens, ``new`` tokens,
    ``gap`` s apart) through the classic paged engine: 8 slots, max_len
    1024, its decode steps replayed CUDA graphs (captured in the warmup).
    With ``eager_arm``, the same workload again with the graph cache
    patched to its eager route (every decode step issued eagerly, as on
    the CPU): each request's tokens
    and events must equal the graphed run's (the order across requests
    follows the engine clock, so it may differ). Returns the graphed
    run's launches and its result."""
    import numpy as np
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 901, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
               for t in lens]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=new,
                        arrival_time=gap * i) for i, p in enumerate(prompts)]

    eng = ContinuousBatchingEngine(model, params, max_slots=8, max_len=1024)
    eng.warmup([int(t) for t in lens])
    widths = eng.core._decode_widths()
    assert eng.core.result()["decode_graphs"] == len(widths)
    outs, counts = {}, {}
    for arm in ("graph", "eager") if eager_arm else ("graph",):
        patch = (mock.patch.object(eng.core._graphs, "eager", True)
                 if arm == "eager" else contextlib.nullcontext())
        with patch:
            torch.cuda.synchronize()
            reset_counts(counters)
            out = eng.run(reqs(), GenerationConfig())
            torch.cuda.synchronize()
            launches = read_counts(counters)
        done = out["requests"]
        assert len(done) == n_req and all(r.done_tokens == new for r in done)
        check_events(out["events"], done)
        expect = serve_expect(launches, cfg, out, lens)
        assert launches == expect, (arm, launches, expect)
        assert out["prefills"] == n_req
        outs[arm] = out
        counts[arm] = encode_forms(launches,
                                   decode_flushes(cfg, out["decode_steps"]))
    assert outs["graph"]["decode_graphs"] == len(widths)   # none recaptured
    if eager_arm:
        assert rid_events(outs["eager"]) == rid_events(outs["graph"]), \
            "graphed and eager decode steps gave different streams"
    for arm, out in outs.items():
        print(f"{label}[{arm}]: {n_req} requests x {new} tokens, 8 slots, "
              f"max_len 1024, {serve_line(out)}; launches "
              f"{json.dumps(counts[arm])}", flush=True)
    if eager_arm:
        g, e = outs["graph"], outs["eager"]
        print(f"{label}: tok/s graphed / eager "
              f"{g['tokens_per_s'] / e['tokens_per_s']:.2f}x, mean decode "
              f"step eager / graphed "
              f"{e['decode_step_s_mean'] / g['decode_step_s_mean']:.2f}x; "
              "each request's tokens and events identical", flush=True)
    return counts["graph"], outs["graph"]


#: each counted kernel wrapper's CUDA kernel functions, as a profile names
#: them (a split paged_decode launch also runs merge_splits_kernel;
#: polar_attention shares paged_decode's functions and is left out)
KERNEL_FNS = {"polar_encode": ("polar_encode_kernel",),
              "paged_decode": ("lut_split_decode_kernel",
                               "lut_flash_decode_kernel"),
              "flash_prefill": ("flash_prefill_kernel",
                                "flash_prefill_mma_kernel"),
              "paged_prefill": ("paged_prefill_kernel",
                                "paged_prefill_mma_kernel"),
              "polar_qk": ("polar_qk_kernel",)}


def profiled_kernels(torch, fn, tries=3, pad=32) -> dict:
    """Kernel launches per CUDA kernel function (``KERNEL_FNS``' names and
    ``merge_splits_kernel``) that the device ran in one call of ``fn``,
    read from torch.profiler. The tracer can lose a trace's first records
    and its last ones (traces of replays of qwen2-moe-a2.7b's graphs lost
    a few leading records, and once a tail holding a layer's encode and
    decode, on an NVIDIA H100 80GB HBM3 at 700 W), and its timestamps do
    not order a replay's records against the host's. So ``pad`` spin
    kernels open the trace and ``pad`` close it, each group followed by a
    synchronize: a loss at either end that stops short of ``fn``'s
    records eats only spins, and the trace is complete when fewer than
    ``pad`` spins are missing. The host also waits 10 ms after the trace
    opens and before it closes: a whole group of spins lost at one end
    (three traces in a row of one replay in ``spec``, same card) points at
    a tracer that starts or drains late. An incomplete trace is taken
    again (``tries`` times at most, then it fails) and says which end was
    short (device timestamps order the spins against ``fn``'s kernels); a
    complete one is counted as it is."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = [f for fns in KERNEL_FNS.values() for f in fns]
    names.append("merge_splits_kernel")

    def spin():
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            spin()
            fn()
            torch.cuda.synchronize()
            spin()
            time.sleep(0.01)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        evs = [e.name for e in dev]
        is_spin = [bool(re.search(r"\bspin_kernel\b", e)) for e in evs]
        spins = sum(is_spin)
        if spins > pad:
            ran = dict.fromkeys(names, 0)
            for e in evs:
                for f in names:
                    ran[f] += bool(re.search(rf"\b{f}\b", e))
            return ran
        starts = [e.time_range.start for e, sp in zip(dev, is_spin) if not sp]
        first = min(starts) if starts else 0
        lead = sum(e.time_range.start < first for e, sp in zip(dev, is_spin)
                   if sp)
        print(f"profile: an incomplete trace ({len(evs)} device records, "
              f"{spins} of {2 * pad} spin kernels: {lead} before the first "
              f"other kernel, {spins - lead} after), taken again", flush=True)
    raise AssertionError(f"no complete trace of {fn} in {tries} profiles")


def check_replay_kernels(torch, graphs, table, slots: int,
                         hkv: int) -> list[str]:
    """Profile one replay of each graph in ``graphs``' cache, every lane
    inactive, and hold the kernels it ran to the launch counts its
    capture recorded (which each replay adds to the wrappers' counters):
    each counted wrapper's kernel functions ran exactly that often, the
    split body as often as paged_decode's ``launches_split`` says, every
    paged_decode launch that splits also ran its merge, and no other
    hand-written kernel ran. Returns one summary per graph."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    lines = []
    for key, cap in graphs._cache.items():
        verify = key[0] == "verify"
        w, h = key[1:3] if verify else key[:2]
        values = {"table": table[:, :w], "active": np.zeros(slots, bool)}
        if verify:
            values |= {"tokens": np.zeros((slots, h), np.int64),
                       "draft_len": np.zeros(slots, np.int32)}
        else:
            values["token"] = np.zeros(slots, np.int64)
        if h > 1 and not verify:
            values |= {"remaining": np.zeros(slots, np.int32),
                       "done": np.ones(slots, bool)}
        ran = profiled_kernels(torch, lambda: graphs._replay(cap, values))
        want = {mod.__name__.rsplit(".", 1)[1]: n
                for (mod, attr), n in cap.counts.items()
                if attr == "launches"}
        got = {name: sum(ran[f] for f in fns)
               for name, fns in KERNEL_FNS.items()}
        assert got == {name: want.get(name, 0) for name in KERNEL_FNS}, \
            (key, got, want)
        split = ran["lut_split_decode_kernel"]
        assert split == cap.counts.get((pd, "launches_split"), 0), (key, ran)
        merges = split if pd.plan_splits(slots, hkv, w) > 1 else 0
        assert ran["merge_splits_kernel"] == merges, (key, ran)
        name = f"{key[3]} verify w {w}, Q {h}" if verify else f"w {w}, H {h}"
        lines.append(f"({name}): {got['polar_encode']} encode + "
                     f"{split} split decode + {merges} merge + "
                     f"{got['polar_qk']} LUT scores")
    return lines


def phase_graphs(torch, model, params, label="graphs") -> None:
    """Each width bucket's decode graph against the eager step at full
    width: 8 slots prefilled to 60-1000 tokens (1-8 live pages), then per
    width a replayed one-token step on the engine's state and the eager
    ``decode_paged`` + sampling on a copy of it, over the slots the width
    covers — logits bit-equal, tokens equal, every buffer equal — and a
    replay with every lane inactive, which must leave the state untouched
    outside the scratch page. Then an H = 8 horizon graph is captured at
    the widest width, and one replay of every captured graph is profiled:
    the kernels it ran must be the launches its capture recorded, which
    is what a replay adds to the wrappers' counters in every serving
    phase (``check_replay_kernels``). Its launches are not part of the
    main path's counts."""
    import copy
    import numpy as np
    from repro_torch.serve import EngineCore, GenerationConfig, Request
    from repro_torch.serve.core import _sample
    cfg = model.cfg
    lens = (60, 200, 300, 500, 700, 900, 130, 1000)
    rng = np.random.default_rng(11)
    core = EngineCore(model, params, max_slots=8, max_len=1024)
    core.reset(GenerationConfig())
    for i, t in enumerate(lens):
        core.add_request(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, (t,)).astype(np.int32), max_new_tokens=8))
    for _ in lens:
        core.step()   # one admission + whole-prompt prefill each
    assert len(core.sched.active) == 8 and not core._prefilling
    dev = core.device

    def tensors(state, drop=None):
        out = []
        for c in state:
            for x in (c.key_codes, *c.key_scales.values(), c.value_codes,
                      c.value_scale, c.value_zero, c.value_fp):
                if x is not None:
                    out.append(x if drop is None else
                               torch.cat([x[:drop], x[drop + 1:]]))
            out += [c.key_residual, c.lengths]
        return out

    def same(a, b, drop=None):
        return all(torch.equal(x, y) for x, y in
                   zip(tensors(a, drop), tensors(b, drop), strict=True))

    scratch = core.layout.scratch_page
    covered = []
    t0 = time.monotonic()
    for w in core._decode_widths():
        lengths = core.state[0].lengths.cpu().numpy()
        mask = lengths // G + 1 <= w
        covered.append(int(mask.sum()))
        assert mask.any()
        tok = rng.integers(0, cfg.vocab_size, 8).astype(np.int64)
        table = core.sched.alloc.table()[:, :w]
        # capture first: its eager run writes the scratch page
        core._graphs.capture(w, 1, 0.0, 0, -1)
        ref = copy.deepcopy(core.state)
        lg, _ = model.decode_paged(params, ref, torch.from_numpy(tok).to(dev),
                                   table.to(dev),
                                   torch.from_numpy(mask).to(dev))
        want = _sample(lg, core.gen)
        logits, nxt = core._graphs.step(w, 0.0, 0, tok, table, mask)
        assert torch.equal(logits, lg), f"width {w}: logits differ"
        assert torch.equal(nxt, want), f"width {w}: tokens differ"
        assert same(core.state, ref), f"width {w}: state differs"
        before = copy.deepcopy(core.state)
        core._graphs.step(w, 0.0, 0, tok, table, np.zeros(8, bool))
        assert same(core.state, before, scratch), \
            f"width {w}: an inactive replay wrote outside the scratch page"
    torch.cuda.synchronize()
    print(f"{label}: widths {core._decode_widths()} covering {covered} of 8 "
          f"prefilled slots: replayed step == eager step on a copy (logits "
          f"bit-equal, tokens, every buffer of {cfg.num_layers} layers); "
          f"inactive replays wrote only the scratch page; "
          f"{time.monotonic() - t0:.1f} s with captures", flush=True)
    core._graphs.capture(core._decode_widths()[-1], 8, 0.0, 0, -1)
    lines = check_replay_kernels(torch, core._graphs,
                                 core.sched.alloc.table(), 8,
                                 cfg.num_kv_heads)
    print(f"{label}: a profiled replay of each of {len(lines)} graphs ran "
          f"exactly the launches its capture recorded ({cfg.num_layers} "
          f"layers; per H = 1 step, H = 8 per horizon): "
          + "; ".join(lines), flush=True)


def phase_runahead(torch, model, params, counters) -> dict:
    """Run-ahead decode (DESIGN.md §18) at full width: 8 greedy requests
    (prompts 100-900 tokens, 128 new tokens, all at t = 0), 8 slots,
    max_len 1024,
    at ``runahead`` 0, 4 and 8: identical streams and per-request events
    (span metadata aside), horizons > 0 at H > 1, exact launches (every
    micro-step of a horizon, frozen lanes included). Then a sampled case
    (temperature 0.8, top_k 8, seed 7, budgets 128 down to 65) at H 1 and
    4: bit-identical streams. Returns the launches of every run,
    summed."""
    import numpy as np
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = model.cfg
    rng = np.random.default_rng(21)
    lens = rng.integers(100, 901, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
               for t in lens]
    sampled = GenerationConfig(temperature=0.8, top_k=8, seed=7)
    cases = [(h, GenerationConfig(), [128] * 8) for h in (0, 4, 8)] + \
        [(h, sampled, [128 - 9 * i for i in range(8)]) for h in (0, 4)]
    total: dict = {}
    greedy, streams = {}, {}
    for h, gen, budgets in cases:
        eng = ContinuousBatchingEngine(model, params, max_slots=8,
                                       max_len=1024, runahead=h)
        eng.warmup([int(t) for t in lens], gen)
        torch.cuda.synchronize()
        reset_counts(counters)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=b)
                       for i, (p, b) in enumerate(zip(prompts, budgets))],
                      gen)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        done = out["requests"]
        assert len(done) == 8
        for r in done:
            assert r.done_tokens == min(budgets[r.rid],
                                        1024 - len(prompts[r.rid]) + 1)
        check_events(out["events"], done)
        expect = serve_expect(launches, cfg, out, lens)
        assert launches == expect, (h, launches, expect)
        ra = out.get("runahead", {})
        if h > 1:
            assert ra["horizons"] > 0, f"H={h}: the planner never engaged"
        kind = "sampled" if gen.temperature > 0 else "greedy"
        streams.setdefault(kind, []).append(
            {r.rid: r.out_tokens for r in done})
        if kind == "greedy":
            greedy[h] = rid_events(out)
        launches = encode_forms(launches, cfg.num_layers
                                * out["decode_steps"])
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        print(f"runahead[H={h}, {kind}]: 8 requests, 8 slots, max_len 1024, "
              f"{serve_line(out)}; horizons {ra.get('horizons', 0)} "
              f"({ra.get('tokens', 0)} tokens), sync wait "
              f"{ra.get('sync_wait_s', 0.0) * 1e3:.2f} ms, dispatch gap "
              f"EWMA {ra.get('dispatch_gap_ewma_s', 0.0) * 1e3:.3f} ms, "
              f"host overlap {ra.get('host_overlap_s', 0.0) * 1e3:.1f} ms; "
              f"graphs {out['decode_graphs']}; launches "
              f"{json.dumps(launches)}", flush=True)
    for kind, runs in streams.items():
        assert all(x == runs[0] for x in runs), f"{kind} streams differ"
    assert greedy[4] == greedy[0] and greedy[8] == greedy[0], \
        "per-request events differ across horizons"
    print("runahead: greedy streams and per-request events identical at H "
          "0, 4 and 8; sampled streams identical at H 1 and 4", flush=True)
    return total


# ---------------------------------------------------------------------------
# speculative multi-token decode (DESIGN.md §15)
# ---------------------------------------------------------------------------

SCRIPTED = "chip-smoke-scripted"


def _scripted_proposer():
    """A proposer that replays a per-rid script (``.script``): the oracle
    when fed a plain run's streams, the adversary when fed argmax + 1."""
    from repro_torch.spec import DraftProposer, register_proposer

    class Scripted(DraftProposer):
        name = SCRIPTED
        script: dict = {}

        def propose(self, req, k):
            s = self.script.get(req.rid, [])
            pos = len(req.out_tokens)
            return [int(t) for t in s[pos:pos + k]]

    return register_proposer(Scripted, overwrite=True)


def spec_expect(launches: dict, cfg, out, prompt_lens) -> tuple[dict, int]:
    """The exact launches of a classic paged serving run with or without
    speculation, and how many encodes are of the decode form. A plain
    step launches the flush encode and the decode attention (#2 on
    ``"paged_fused"``, #6 on ``"jnp"``) once a layer; a verify of span
    width q launches, per layer, 2q encodes and q paged decodes (the scan
    verifier: q steps on the shadow state, q masked commits) or 2
    encodes and 2 score-only LUT launches (the span verifier: the flush
    emulation and the commit; the pages and the flushed group). Per
    layer means per polar layer (``polar_layers``), but flash prefill."""
    nl, npl = cfg.num_layers, polar_layers(cfg)
    sp = out.get("spec", {})
    hist = sp.get("dispatches_by_q", {})
    plain = out["decode_steps"] - sp.get("steps", 0)
    scan = cfg.decode_backend != "jnp"
    attn = "paged_decode" if scan else "polar_qk"
    flushes = npl * plain + sum(n * npl * (2 * q if scan else 2)
                                for q, n in hist.items())
    full = sum(int(t) >= G for t in prompt_lens)
    enc = encode_name(cfg)
    return ({**dict.fromkeys(launches, 0),
             enc: npl * full + flushes,
             attn: npl * plain + sum(n * npl * (q if scan else 2)
                                     for q, n in hist.items()),
             "flash_prefill": nl * out["prefills"]},
            flushes if enc == "polar_encode" else 0)


def _qk_span_check(torch, q_n=5) -> str:
    """#6 at the span verifier's shape: 8 slots x 4 kv heads x (8 query
    heads x Q) rows over an 8-page view, against its plain version, and
    timed (kernel, plain, one launch of the one-token step's 8 rows)."""
    from repro_torch.kernels import polar_qk as qkk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bufs, _ = _dense_cache(torch, dev, gen)
    bufs = [x[:, :, :8].contiguous() for x in bufs]
    qh = QH * q_n
    q = torch.randn((SB, HKV, qh, D), generator=gen, device=dev) * D ** -0.5
    got = qkk.polar_qk_scores(q, *bufs)
    ref = qkk.polar_qk_scores_plain(q, *bufs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=FP32_TOL, atol=FP32_TOL)
    one = qkk.polar_qk_scores(q[:, :, :QH].contiguous(), *bufs)
    assert torch.equal(one, got[:, :, :QH]), "rows depend on Qh"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(torch, lambda: qkk.polar_qk_scores(q, *bufs), flush=flush)
    q8 = q[:, :, :QH].contiguous()
    ms8 = time_ms(torch, lambda: qkk.polar_qk_scores(q8, *bufs), flush=flush)
    plain_ms = time_ms(torch, lambda: qkk.polar_qk_scores_plain(q, *bufs),
                       iters=10, flush=flush, lead_cycles=PLAIN_LEAD)
    groups = SB * HKV * 8
    per = 3 * qh * P * 16 + 2 * G * P + 2 * qh * G * P
    b_ms, by = bound(q.numel() * 4 + groups * (G * P + 4 * P * 4)
                     + SB * HKV * qh * 8 * G * 4, groups * per)
    return (f"qk[span shape]: {SB} rows x {HKV} kv heads x {qh} query heads "
            f"(Q {q_n}) x 8 groups: err "
            f"{float((got - ref).abs().max()):.3g} (limit {FP32_TOL}), rows "
            f"bit-equal to a {QH}-head launch; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms {by}; the step's "
            f"{QH}-head launch {ms8:.4f} ms)")


def _row_probe(torch) -> str:
    """Why the span verifier runs its GEMMs and attention einsums
    per span column: whether the rows of one op over 8 * Q rows (the span
    folded onto the row axis) are bit-equal to the same op over each
    column's 8 rows, at tinyllama's shapes, random inputs (reported, not
    gated; the verifier does not depend on it)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def r(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def folded_equal(fn, x):   # x (8, Q, K): fn over 8 Q rows vs per column
        y = fn(x)
        return all(torch.equal(y[:, i:i + 1], fn(x[:, i:i + 1].contiguous()))
                   for i in range(x.shape[1]))

    out = []
    for k, n in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                 (2048, 32000)):
        w = r(k, n)
        same = [q for q in (2, 3, 5, 9)
                if folded_equal(lambda x: x @ w, r(8, q, k))]
        out.append(f"GEMM {k}x{n} equal at Q {same}")
    # the attention einsums, span columns folded onto the query-head axis
    # as span_verify_attention folds them: rows (query head, column)
    res = r(8, HKV, G, D, dt=torch.float32)
    v = r(8, HKV, 8 * G, D, dt=torch.float32)
    for name, rhs, dim, eq in (
            ("residual scores", res, D, "bhqd,bhgd->bhqg"),
            ("p @ V", v, 8 * G, "bhqt,bhtd->bhqd")):
        same = []
        for q in (2, 3, 5, 9):
            x = r(8, HKV, QH, q, dim, dt=torch.float32)
            if name == "p @ V":
                x = torch.softmax(x, -1)
            y = torch.einsum(eq, x.reshape(8, HKV, QH * q, dim), rhs)
            y = y.reshape(8, HKV, QH, q, -1)
            if all(torch.equal(y[:, :, :, i], torch.einsum(
                    eq, x[:, :, :, i].contiguous(), rhs)) for i in range(q)):
                same.append(q)
        out.append(f"{name} equal at Q {same}")
    return ("spec: rows of a folded op bit-equal to the per-column op (8 "
            "rows a column, Q 2/3/5/9): " + "; ".join(out))


def _verify_core_checks(torch, models, params, lens, rng) -> list[str]:
    """Per verifier, on an EngineCore holding 8 prefilled slots (60-1000
    tokens): each span width's verify graph at the widest table against
    a fresh eager verifier on a copy of the state (argmaxes, accepted
    counts, every buffer outside the scratch page bit-equal; some drafts
    accepted), an all-inactive replay that writes only the scratch page,
    a profiled replay of every captured graph (``check_replay_kernels``),
    and the device time of each verify replay against the one-token step
    replay (CUDA events, every lane inactive: the same work, no commit).
    Launches here are not part of the main path's counts."""
    import copy
    import numpy as np
    from repro_torch.serve import EngineCore, GenerationConfig, Request
    from repro_torch.spec import SpecConfig, make_verifier
    lines = []
    for backend, m in models.items():
        core = EngineCore(m, params, max_slots=8, max_len=1024,
                          spec=SpecConfig(mode="ngram", k=4))
        core.reset(GenerationConfig())
        for i, t in enumerate(lens):
            core.add_request(Request(rid=i, prompt=rng.integers(
                0, m.cfg.vocab_size, (t,)).astype(np.int32),
                max_new_tokens=8))
        for _ in lens:
            core.step()
        assert len(core.sched.active) == 8 and not core._prefilling
        dev, s = core.device, 8
        scratch = core.layout.scratch_page
        w = core._decode_widths()[-1]
        table = core.sched.alloc.table()[:, :w]
        mask = np.ones(s, bool)
        accepted, times = 0, {}
        core._graphs.capture(w, 1, 0.0, 0, -1)
        for q in core._spec_q_buckets():
            toks = rng.integers(0, m.cfg.vocab_size, (s, q))
            toks[:, 0] = core._next_tok
            dlen = np.full(s, q - 1, np.int32)
            probe = copy.deepcopy(core.state)
            pred0 = make_verifier(m)(
                params, probe, torch.from_numpy(toks).to(dev),
                torch.from_numpy(dlen).to(dev), table.to(dev),
                torch.from_numpy(mask).to(dev))[0]
            toks[::2, 1] = pred0[::2, 0].cpu().numpy()
            del probe
            core._graphs.capture_verify(w, q)
            ref = copy.deepcopy(core.state)
            want = make_verifier(m)(
                params, ref, torch.from_numpy(toks).to(dev),
                torch.from_numpy(dlen).to(dev), table.to(dev),
                torch.from_numpy(mask).to(dev))
            preds, n_acc = core._graphs.verify(w, q, toks, dlen, table, mask)
            assert torch.equal(preds, want[0]), f"{backend} q {q}: preds"
            assert torch.equal(n_acc, want[1]), f"{backend} q {q}: n_acc"
            assert _same_state(torch, core.state, ref, scratch), \
                f"{backend} q {q}: committed state differs"
            accepted += int(n_acc.sum())
            del ref
            before = copy.deepcopy(core.state)
            core._graphs.verify(w, q, toks, dlen, table, np.zeros(s, bool))
            assert _same_state(torch, core.state, before, scratch), \
                f"{backend} q {q}: an inactive replay wrote outside scratch"
            del before
            cap = core._graphs.capture_verify(w, q)
            off = {"tokens": toks, "draft_len": dlen, "table": table,
                   "active": np.zeros(s, bool)}
            times[q] = time_ms(torch, lambda: core._graphs._replay(cap, off),
                               iters=10, lead_cycles=PLAIN_LEAD)
        assert accepted > 0, f"{backend}: no draft accepted"
        step = core._graphs.capture(w, 1, 0.0, 0, -1)
        soff = {"token": core._next_tok.astype(np.int64), "table": table,
                "active": np.zeros(s, bool)}
        step_ms = time_ms(torch, lambda: core._graphs._replay(step, soff),
                          iters=10, lead_cycles=PLAIN_LEAD)
        kind = core._graphs.verifier.kind
        lines.append(
            f"spec[{kind} verifier, {backend}]: graphed verify == eager "
            f"verify (argmaxes, accepted counts, every buffer outside the "
            f"scratch page) at width {w} for Q {list(times)}, {accepted} "
            f"drafts accepted; inactive replays wrote only the scratch page; "
            f"device ms per replay at 8 slots x 60-1000 tokens: step "
            f"{step_ms:.3f}; verify " + ", ".join(
                f"Q {q} {t:.3f} ({t / step_ms:.2f}x step, "
                f"{t / step_ms / q:.2f}x per column)"
                for q, t in times.items()))
        lines.append("spec: a profiled replay of each graph ran exactly the "
                     "launches its capture recorded: " + "; ".join(
                         check_replay_kernels(torch, core._graphs,
                                              core.sched.alloc.table(), s,
                                              m.cfg.num_kv_heads)))
    return lines


def _same_state(torch, a, b, scratch) -> bool:
    """Every buffer of every layer equal, the scratch pool page aside."""
    def tensors(state):
        for c in state:
            for x in (c.key_codes, *c.key_scales.values(), c.value_codes,
                      c.value_scale, c.value_zero, c.value_fp):
                if x is not None:
                    yield torch.cat([x[:scratch], x[scratch + 1:]])
            yield c.key_residual
            yield c.lengths
    return all(torch.equal(x, y)
               for x, y in zip(tensors(a), tensors(b), strict=True))


def phase_spec(torch, model, params, counters) -> dict:
    """Speculative multi-token decode (DESIGN.md §15) at full width: 8
    slots, max_len 1024, 8 greedy requests (prompts 100-900 tokens, 128
    new tokens, all at t = 0), ``SpecConfig(k=4)``. Arms: (a) plain
    ``"paged_fused"``, (b) ngram on the scan verifier, (c) plain
    ``"jnp"``, (d) ngram on the span verifier, (e) arm (d) eager, (f)
    the scripted oracle (replays (c)'s streams: acceptance 1), (g) the
    scripted adversary (argmax + 1: acceptance 0), all graphed but (e);
    then a derived 2-layer draft model (k 4) on 2 requests (64-token
    prompts, 32 new tokens) against the plain run. Every spec arm's
    streams and per-request events equal its plain arm's, no proposer
    faulted, exact launches (#6 in (d), #2 in (b)). Before the arms: the
    verify graphs against eager verifies and their device time per span
    width (``_verify_core_checks``), and #6 at the span shape. Returns the
    launches of every arm, summed."""
    import dataclasses
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
        check_event_stream,
    )
    from repro_torch.spec import SpecConfig
    t_phase = time.monotonic()
    cfg = model.cfg
    models = {b: get_model(dataclasses.replace(cfg, decode_backend=b))
              for b in ("paged_fused", "jnp")}
    rng = np.random.default_rng(41)
    for line in _verify_core_checks(
            torch, models, params, (60, 200, 300, 500, 700, 900, 130, 1000),
            rng):
        print(line, flush=True)
    print(_qk_span_check(torch), flush=True)
    print(_row_probe(torch), flush=True)
    t_arms = time.monotonic()
    lens = rng.integers(100, 901, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
               for t in lens]
    dprompts = [rng.integers(0, cfg.vocab_size, (64,)).astype(np.int32)
                for _ in range(2)]
    scripted = _scripted_proposer()
    total: dict = {}
    outs: dict = {}

    def engine(backend, spec, plens):
        eng = ContinuousBatchingEngine(models[backend], params, max_slots=8,
                                       max_len=1024, spec=spec)
        eng.warmup([int(t) for t in plens])
        return eng

    def run(arm, eng, ps, new, eager=False):
        patch = (mock.patch.object(eng.core._graphs, "eager", True)
                 if eager else contextlib.nullcontext())
        with patch:
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.monotonic()
            out = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                           for i, p in enumerate(ps)], GenerationConfig())
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts(counters)
        done = out["requests"]
        assert len(done) == len(ps)
        for r in done:
            assert r.done_tokens == min(new, 1024 - len(ps[r.rid]) + 1)
        check_events(out["events"], done)
        check_event_stream(out["events"])
        assert out["proposer_faults"] == 0, f"({arm}): a proposer faulted"
        expect, flushes = spec_expect(launches, eng.core.model.cfg, out,
                                      [len(p) for p in ps])
        assert launches == expect, (arm, launches, expect)
        counts = encode_forms(launches, flushes)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        sp = out.get("spec")
        print(f"spec({arm}) {eng.core.model.cfg.decode_backend}"
              + (f" {sp['mode']} k {sp['k']}" if sp else " plain")
              + (" eager" if eager else "") + f": {len(ps)} requests x "
              f"{new} tokens, {serve_line(out)}; run {wall:.2f} s; graphs "
              f"{out['decode_graphs']}" + (
                  f"; spec steps {sp['steps']} (by Q "
                  f"{json.dumps(sp['dispatches_by_q'])}), drafted "
                  f"{sp['drafted_tokens']}, accepted {sp['accepted_tokens']}"
                  f", acceptance {sp['acceptance_rate']:.3f}, mean accepted "
                  f"per step {sp['mean_accepted_per_step']:.3f}"
                  if sp else "") + f"; launches {json.dumps(counts)}",
              flush=True)
        outs[arm] = out
        return out

    ngram = SpecConfig(mode="ngram", k=4)
    plain_pf = engine("paged_fused", None, lens)
    run("a", plain_pf, prompts, 128)
    run("b", engine("paged_fused", ngram, lens), prompts, 128)
    run("c", engine("jnp", None, lens), prompts, 128)
    span = engine("jnp", ngram, lens)
    run("d", span, prompts, 128)
    run("e", span, prompts, 128, eager=True)
    oracle = engine("jnp", SpecConfig(mode=SCRIPTED, k=4), lens)
    base = {r.rid: list(r.out_tokens) for r in outs["c"]["requests"]}
    scripted.script = base
    run("f", oracle, prompts, 128)
    scripted.script = {rid: [(t + 1) % cfg.vocab_size for t in ts]
                       for rid, ts in base.items()}
    run("g", oracle, prompts, 128)
    run("draft-plain", plain_pf, dprompts, 32)
    run("draft", engine("paged_fused", SpecConfig(mode="draft", k=4),
                        [64, 64]), dprompts, 32)

    for arm, ref in (("b", "a"), ("d", "c"), ("e", "d"), ("f", "c"),
                     ("g", "c"), ("draft", "draft-plain")):
        assert rid_events(outs[arm]) == rid_events(outs[ref]), \
            f"({arm}) streams or events differ from ({ref})"
    for arm in ("b", "d", "e", "f", "g", "draft"):
        assert outs[arm]["spec"]["steps"] > 0, f"({arm}) never verified"
    assert outs["d"]["spec"] == outs["e"]["spec"]
    f, g = outs["f"]["spec"], outs["g"]["spec"]
    assert f["drafted_tokens"] > 0 and f["acceptance_rate"] == 1.0
    assert g["drafted_tokens"] > 0 and g["accepted_tokens"] == 0
    print(f"spec: arms (b)-(g) and the draft arm give their plain arm's "
          f"streams and per-request events; graphed (d) == eager (e); no "
          f"proposer fault; tok/s vs plain: " + ", ".join(
              f"({a}) {outs[a]['tokens_per_s'] / outs[r]['tokens_per_s']:.2f}x"
              for a, r in (("b", "a"), ("d", "c"), ("f", "c"), ("g", "c"),
                           ("draft", "draft-plain")))
          + f"; arms {time.monotonic() - t_arms:.1f} s, phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 6: chunked prefill + the shared-prefix page cache at full width
# ---------------------------------------------------------------------------


def _chunk_plan(ctx_lens, hits, c):
    """(chunks computed, chunks holding a full key group) of a workload:
    request i prefills [hits[i], ctx_lens[i]) in chunks of c tokens."""
    n = full = 0
    for tl, hit in zip(ctx_lens, hits):
        for off in range(hit, tl, c):
            n += 1
            full += min(c, tl - off) >= G
    return n, full


def phase_prefix(torch, model, params, counters, n_req=12, new=32, seed=3,
                 arms=(True, False), label="prefix") -> dict:
    """``n_req`` greedy requests that share one 1024-token system prompt:
    rid 0 at t = 0, the rest at t = 5 s (the idle clock jumps there, so
    rid 0's prompt pages are registered before any later admission).
    Served chunked with the prefix cache and/or without it (``arms``: the
    streams of the two must be equal); returns the launches of the runs,
    summed."""
    import numpy as np
    from repro_torch.kernels import paged_prefill as ppk
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    sys_len = 1024
    system = rng.integers(0, cfg.vocab_size, (sys_len,)).astype(np.int32)
    suffixes = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
                for t in rng.integers(32, 401, n_req)]
    prompts = [np.concatenate([system, s]) for s in suffixes]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=new,
                        arrival_time=0.0 if i == 0 else 5.0)
                for i, p in enumerate(prompts)]

    runs, launches = {}, {}
    form = value_form(cfg)
    for shared in arms:
        eng = ContinuousBatchingEngine(model, params, max_slots=8,
                                       max_len=2048, prefill_chunk=TC,
                                       prefix_cache=shared)
        eng.warmup([len(p) for p in prompts])
        torch.cuda.synchronize()
        reset_counts(counters)
        out = eng.run(reqs(), GenerationConfig())
        torch.cuda.synchronize()
        got = read_counts(counters)
        mma = ppk.launches_mma
        done = out["requests"]
        assert len(done) == n_req and all(r.done_tokens == new for r in done)
        check_events(out["events"], done)
        hits = [0] + [sys_len] * (n_req - 1) if shared else [0] * n_req
        chunks, full = _chunk_plan([len(p) for p in prompts], hits, TC)
        npl, steps = polar_layers(cfg), out["decode_steps"]
        expect = {**dict.fromkeys(got, 0),
                  encode_name(cfg): npl * (full + steps),
                  f"paged_decode{form}": npl * steps,
                  f"paged_prefill{form}": npl * chunks}
        assert got == expect, (shared, got, expect)
        assert mma == npl * chunks, ("paged prefill off the tensor cores",
                                     mma, npl * chunks)
        assert out["prefills"] == chunks
        assert out["cow_splits"] == 0
        runs[shared] = out
        launches[shared] = encode_forms(got, decode_flushes(cfg, steps))
    streams = [{r.rid: r.out_tokens for r in out["requests"]}
               for out in runs.values()]
    assert all(x == streams[0] for x in streams), \
        "greedy streams differ with and without the prefix cache"
    for shared, out in runs.items():
        assert out["adopted_pages"] == \
            (n_req - 1) * (sys_len // G) * shared, out["adopted_pages"]
    for shared, out in runs.items():
        name = "shared" if shared else "unshared"
        print(f"{label}[{name}]: {n_req} requests x {new} tokens (1024-token "
              f"system prompt + 32-400-token suffixes), 8 slots, max_len "
              f"2048, chunk {TC}: {out['total_tokens']} tokens in "
              f"{out['wall_s']:.3f} s = {out['tokens_per_s']:.1f} tok/s; "
              f"TTFT p50 {out['p50_ttft_s'] * 1e3:.1f} ms p99 "
              f"{out['p99_ttft_s'] * 1e3:.1f} ms; {out['prefills']} chunks "
              f"{out['prefill_s_total']:.3f} s; decode {out['decode_steps']} "
              f"steps mean {out['decode_step_s_mean'] * 1e3:.2f} ms; prefix "
              f"hit rate {out['prefix_hit_rate']:.3f}, adopted pages "
              f"{out['adopted_pages']}, bytes saved "
              f"{out.get('prefix_pool_bytes_saved', 0)}; launches "
              f"{json.dumps(launches[shared])} (paged_prefill all on the "
              "tensor-core body)", flush=True)
    return {k: sum(x[k] for x in launches.values()) for k in launches[arms[0]]}


# ---------------------------------------------------------------------------
# phase 7: the static-batching engine over dense caches at full width
# ---------------------------------------------------------------------------


def _teacher_logits(torch, model, params, batch, tokens, steps,
                    max_len=SMAX):
    """Logits (steps + 1, B, V) fp32 of a prefill of ``batch`` (tokens,
    and a VLM's patches) then ``steps`` decode steps fed ``tokens[:,
    :steps]``, and the state."""
    prompts = batch["tokens"]
    state = model.init_decode_state(prompts.shape[0], max_len,
                                    prompts.device)
    lg, state = model.prefill(params, batch, state)
    out = [lg.float()]
    for i in range(steps):
        lg, _ = model.decode(params, state, tokens[:, i])
        out.append(lg.float())
    return torch.stack(out), state


def _static_layer_bytes(q, hkv=HKV, d=D) -> int:
    """Bytes of one layer's dense cache under ``q`` at the static shape (8
    rows, ``hkv`` kv heads — tinyllama's 4 by default —, 1152 tokens, head
    dim ``d`` — 64 by default —, g 128): polar keys as one code
    byte per pair, four fp32 stat rows per group and the bf16 residual
    group; int keys as one code byte per element and an fp32 scale and
    zero per token; bf16 keys for ``"none"``. Values as bf16 rows, or
    uint8 codes with an fp32 scale and zero per row; the int32 length."""
    rows, p = SB * hkv * SMAX, d // 2
    keys = {"polar": rows * p + 4 * SB * hkv * SG * p * 4
            + SB * hkv * G * d * 2,
            "int": rows * d + 2 * rows * 4,
            "none": rows * d * 2}[q.method]
    return keys + (rows * (d + 8) if q.value_bits else rows * d * 2) + 4


STATIC_RUNS = (("polar", "jnp"), ("polar", "paged_fused"), ("none", "jnp"))


def phase_static(torch, cfg, params, counters, runs=STATIC_RUNS,
                 label="static", gate_steps=8) -> dict:
    """``ServeEngine`` at full width: 8 rows, 1000-token prompts (one group
    flush, at position 1023, falls inside the decode loop), 64 greedy new
    tokens, max_len 1152; ``runs`` of (codec, decode route): polar on the
    score-only route (``"jnp"``), polar on the fused route
    (``"paged_fused"``) and the fp ``"none"`` cache. A VLM's prompt is its
    ``frontend_tokens`` image tokens (seeded random patch embeddings on
    the card) and 1000 - frontend_tokens text tokens. Counters are set to
    0 just before each generate and read just after; returns the launches
    of the runs, summed. The logit gate covers the prefill and the first
    ``gate_steps`` decode steps. Under a per-layer policy
    (``cfg.cache_policy``, which the codec of ``runs`` does not replace)
    the kernels run in its polar layers only."""
    import dataclasses
    import numpy as np
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, ServeEngine
    t_phase = time.monotonic()
    dev = params["embed"].device
    image = cfg.frontend_tokens if cfg.family == "vlm" else 0
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SB, SPROMPT - image)), device=dev).long()
    batch = {"tokens": prompts}
    if image:
        pgen = torch.Generator(device=dev)
        pgen.manual_seed(4)
        batch["patches"] = torch.randn((SB, image, cfg.frontend_dim),
                                       generator=pgen, device=dev)
    nl, steps = cfg.num_layers, SNEW - 1
    shape = (cfg.num_kv_heads, cfg.head_dim)
    total: dict = {}
    models, toks, per_layer = {}, {}, {}
    for method, backend in runs:
        name = f"{method}/{backend}"
        model = get_model(dataclasses.replace(
            cfg, decode_backend=backend,
            quant=dataclasses.replace(cfg.quant, method=method)))
        eng = ServeEngine(model, params, max_len=SMAX)
        eng.generate(batch, GenerationConfig(max_new_tokens=2))
        torch.cuda.synchronize()
        reset_counts(counters)
        out = eng.generate(batch,
                           GenerationConfig(max_new_tokens=SNEW))
        torch.cuda.synchronize()
        got = read_counts(counters)
        npl = polar_layers(model.cfg)
        # prefill encodes its 7 full groups in one launch per polar layer,
        # the append at position 1023 flushes once (the decode form); one
        # attention launch per polar layer and decode step on the run's
        # route
        route = ("polar_attention" + value_form(cfg)
                 if backend == "paged_fused" else "polar_qk")
        expect = {**dict.fromkeys(got, 0), "polar_encode": 2 * npl,
                  "flash_prefill": nl}
        if npl:
            expect[route] = npl * steps
        assert got == expect, (name, got, expect)
        # every fused-route launch on the split body
        fused = got["polar_attention" + value_form(cfg)]
        assert pak.launches_split == fused, \
            (name, "polar_attention off the split body", pak.launches_split)
        # the decode form: the flush at position 1023, once per polar layer
        got = encode_forms(got, npl)
        assert out["tokens"].shape == (SB, SNEW)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        models[name], toks[name] = model, out["tokens"]
        per_layer[name] = out["cache_bytes_per_layer"]
        assert per_layer[name] == [
            _static_layer_bytes(model.cfg.policy.layer_config(i), *shape)
            for i in range(nl)] and \
            out["cache_bytes"] == sum(per_layer[name]), per_layer[name]
        gate = ""
        if npl:
            # gate 1: the logits after prefill and over the first
            # gate_steps decode steps, against the same run with every
            # kernel's plain version
            tok_t = torch.as_tensor(out["tokens"], device=dev).long()
            routes: list = []
            with record_routes(routes):
                kern, _ = _teacher_logits(torch, model, params, batch,
                                          tok_t, gate_steps)
            # an MoE model's plain run takes the kernel run's experts
            with plain_kernels(), replay_routes(routes):
                plain, _ = _teacher_logits(torch, model, params, batch,
                                           tok_t, gate_steps)
            rel = ((kern - plain).norm(dim=-1) / plain.norm(dim=-1))
            assert torch.isfinite(kern).all()
            assert float(rel.max()) <= MODEL_REL_L2, \
                f"{name} logits drift {rel.flatten().tolist()}"
            free = free_routing(torch, lambda: _teacher_logits(
                torch, model, params, batch, tok_t, gate_steps)[0], kern,
                routes)
            agree = float((kern.argmax(-1) == plain.argmax(-1)).float()
                          .mean())
            gate = (f"; rel. L2 logits vs plain over prefill + {gate_steps} "
                    f"steps max {float(rel.max()):.3e} "
                    f"(prefill {float(rel[0].max()):.3e}, limit "
                    f"{MODEL_REL_L2}; argmax agreement {agree:.4f}" + (
                        f", MoE routing replayed; plain with its own "
                        f"routing: {free['flips']:.4f} of routing decisions "
                        f"differ, median "
                        f"{float(free['free_rel'].median()):.3e} max "
                        f"{float(free['free_rel'].max()):.3e}"
                        if free else "") + ")")
        bits = [kvc.cache_logical_bits(c)
                for c in model.init_decode_state(1, G, dev)]
        print(f"{label}[{name}]: {SB} rows x {SPROMPT}-token prompts, "
              f"{SNEW} greedy tokens, max_len {SMAX}: prefill "
              f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s = "
              f"{out['tokens_per_s']:.1f} tok/s, step "
              f"{out['decode_s'] / steps * 1e3:.3f} ms; cache "
              f"{sum(per_layer[name]) / nl:.0f} B per layer "
              f"({sum(bits) / nl:.4f} logical key "
              f"bits/element){gate}; launches {json.dumps(got)}",
              flush=True)
    polar_bytes = sum(per_layer["polar/jnp"]) / nl
    a, b = toks["polar/jnp"], toks["polar/paged_fused"]
    same = a == b
    fp_bytes = _static_layer_bytes(QuantConfig("none"), *shape)
    bf16_bytes = _static_layer_bytes(QuantConfig(), *shape)
    line = (f"{label}: cache bytes per layer polar / fp = "
            f"{polar_bytes / fp_bytes:.4f}, "
            f"polar / polar with bf16 values = "
            f"{polar_bytes / bf16_bytes:.4f}; greedy "
            f"tokens of the score-only and fused routes agree on "
            f"{float(same.mean()):.4f} of {same.size}")
    if not same.all():
        # the earliest step at which any row differs: every row fed both
        # runs the same tokens before it, so the logits there compare
        i = int(np.argmax((~same).any(axis=0)))
        r = int(np.argmax(~same[:, i]))
        ta, tb = int(a[r, i]), int(b[r, i])
        margins = []
        for name, x, y in (("polar/jnp", ta, tb),
                           ("polar/paged_fused", tb, ta)):
            lg, _ = _teacher_logits(
                torch, models[name], params, batch,
                torch.as_tensor(a, device=dev).long(), i)
            margins.append(float(lg[i, r, x] - lg[i, r, y]))
        line += (f"; first divergence at row {r}, token {i}: {ta} vs {tb}, "
                 f"logit margin {margins[0]:.4f} (score-only route) / "
                 f"{margins[1]:.4f} (fused route)")
    print(line + f"; phase {time.monotonic() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 8: quantized values (QuantConfig(value_bits=4)) at full width
# ---------------------------------------------------------------------------


def _values_gate(torch, model, params) -> tuple[float, float]:
    """Max rel. L2 of the logits, kernels vs plain versions, over a
    1100-token prompt prefilled in 256-token chunks (kernel #4 on uint8
    prefix values from the second chunk on) and 16 teacher-forced decode
    steps (kernel #2); and the prefill's own."""
    from repro_torch.core.cache_layout import PagedLayout
    dev = torch.device("cuda")
    rng = torch.Generator(device="cpu")
    rng.manual_seed(5)
    t0, steps, pages = 1100, 16, 16
    toks = torch.randint(0, model.cfg.vocab_size, (t0 + steps,),
                         generator=rng)
    layout = PagedLayout(page_size=G, num_pages=pages, slots=1,
                         pages_per_slot=pages)
    table = torch.arange(pages, dtype=torch.int32, device=dev)[None]

    def run():
        state = model.init_paged_state(layout, dev)
        for start in range(0, t0, TC):
            n = min(TC, t0 - start)
            chunk = torch.zeros((1, TC), dtype=torch.long)
            chunk[0, :n] = toks[start:start + n]
            lg, _ = model.prefill_paged_chunk(params, chunk.to(dev), state, 0,
                                              table[0], start, n)
        out = [lg.float()]
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        for i in range(steps):
            lg, _ = model.decode_paged(params, state,
                                       toks[t0 + i:t0 + i + 1].to(dev),
                                       table, active)
            out.append(lg.float())
        return torch.stack(out)

    kern = run()
    with plain_kernels():
        plain = run()
    rel = ((kern - plain).norm(dim=-1) / plain.norm(dim=-1)).flatten()
    assert torch.isfinite(kern).all()
    assert float(rel.max()) <= MODEL_REL_L2, f"logits drift {rel.tolist()}"
    return float(rel.max()), float(rel[0])


def phase_values(torch, cfg, params, counters) -> dict:
    """Full-width tinyllama-1.1b with ``QuantConfig(value_bits=4)`` on the
    same weights: a logit gate on the paged path (chunked prefill + decode,
    kernels vs plain versions); the ``serve`` phase's classic paged serving
    with 8 requests of 32 tokens; the ``prefix`` phase's chunked prefill
    with the shared-prefix cache, 6 requests of 16 tokens, shared arm only
    (every uint8 paged prefill launch on the tensor-core body); the
    ``static`` phase's two polar routes, gated against their plain paths,
    with their cache bytes per layer. Returns the launches of the serving
    runs, summed."""
    import dataclasses
    from repro_torch.models import get_model
    t_phase = time.monotonic()
    vcfg = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, value_bits=4))
    model = get_model(vcfg)
    gate, gate_pre = _values_gate(torch, model, params)
    print(f"values[gate]: 4-bit values, 1100-token prompt in {TC}-token "
          f"chunks + 16 teacher-forced decode steps; relative L2 logit error "
          f"kernel vs plain per step max {gate:.3e} (prefill {gate_pre:.3e}, "
          f"limit {MODEL_REL_L2})", flush=True)
    runs = [phase_serve(torch, model, params, counters, n_req=8, new=32,
                        seed=6, label="values:serve", eager_arm=False)[0],
            phase_prefix(torch, model, params, counters, n_req=6, new=16,
                         seed=7, arms=(True,), label="values:prefix"),
            phase_static(torch, vcfg, params, counters, runs=STATIC_RUNS[:2],
                         label="values:static")]
    print(f"values: phase {time.monotonic() - t_phase:.1f} s", flush=True)
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# ---------------------------------------------------------------------------
# phase 9: the baseline key codecs and per-layer cache policies
# ---------------------------------------------------------------------------

#: bytes of one pool page of one layer (4 kv heads, d 64, g 128, bf16
#: values: 65,536 B of each) by codec: polar one code byte per pair and
#: four fp32 stat rows; kivi one code byte per element and an fp32 scale
#: and zero per channel; int one code byte per element and an fp32 scale
#: and zero per token; zipcache those of int and an fp32 norm per channel;
#: none the bf16 keys
PAGE_BYTES = {"polar": 83_968, "kivi": 100_352, "int": 102_400,
              "zipcache": 103_424, "none": 131_072}
#: the codecs phase's arms' logical key bits per element (d 64, g 128)
ARM_BITS = {"int8": 8.5, "int4": 4.5, "kivi4": 4.25, "zipcache4": 4.625,
            "none": 16.0, "polar-fixed": 4.125,
            "mixed": (2 * 8.5 + (LATER_DEPTH - 2) * 4.25) / LATER_DEPTH}


def codec_arms(cfg) -> dict:
    """The codecs phase's model configs: int8, int4, KIVI 4-bit, ZipCache
    4-bit, the fp passthrough, polar on the fixed angle grid, and
    ``CachePolicy.first_k(2, int8, polar)``."""
    import dataclasses
    from repro_torch.core.codecs import CachePolicy
    q = cfg.quant

    def quant(**kw):
        return dataclasses.replace(cfg, quant=dataclasses.replace(q, **kw))

    int8 = dataclasses.replace(q, method="int", key_bits=8)
    return {"int8": quant(method="int", key_bits=8),
            "int4": quant(method="int", key_bits=4),
            "kivi4": quant(method="kivi", key_bits=4),
            "zipcache4": quant(method="zipcache", key_bits=4),
            "none": quant(method="none"),
            "polar-fixed": quant(theta_stats="fixed"),
            "mixed": dataclasses.replace(
                cfg, cache_policy=CachePolicy.first_k(2, int8, q))}


def paged_layer_bytes(model, dev) -> list[int]:
    """Each layer's paged cache bytes at the serving shape (8 slots x 8
    pages, 65 pool pages with the scratch page), asserted exactly: the
    pool pages at ``PAGE_BYTES``, a grouped codec's bf16 residual group
    per slot and kv head, the int32 lengths."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.utils import tree_bytes
    lay = PagedLayout(page_size=G, num_pages=64, slots=8, pages_per_slot=8)
    state = model.init_paged_state(lay, dev)
    got, want = [], []
    for i, c in enumerate(state):
        page = PAGE_BYTES[model.cfg.policy.layer_config(i).method]
        assert pgc.pool_page_bytes(c) == page, (i, pgc.pool_page_bytes(c))
        want.append(lay.pool_pages * page + 8 * 4
                    + (8 * HKV * G * D * 2 if c.grouped else 0))
        got.append(tree_bytes(c))
    assert got == want, (got, want)
    return got


def codecs_spec(torch, cfg, params, counters) -> dict:
    """Speculative decode under ``cfg``'s policy: 8 greedy requests
    (prompts 100-900, 64 new tokens, all at t = 0), plain and
    ``SpecConfig(k=4)`` ngram arms on the scan (``"paged_fused"``) and the
    span (``"jnp"``) verifier, graphed: each spec arm's streams and
    per-request events equal its plain arm's, exact launches
    (``spec_expect``). Returns the launches, summed."""
    import dataclasses
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
        check_event_stream,
    )
    from repro_torch.spec import SpecConfig
    rng = np.random.default_rng(43)
    lens = rng.integers(100, 901, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
               for t in lens]
    total, outs = {}, {}
    for backend in ("paged_fused", "jnp"):
        model = get_model(dataclasses.replace(cfg, decode_backend=backend))
        for spec in (None, SpecConfig(mode="ngram", k=4)):
            eng = ContinuousBatchingEngine(model, params, max_slots=8,
                                           max_len=1024, spec=spec)
            eng.warmup([int(t) for t in lens])
            torch.cuda.synchronize()
            reset_counts(counters)
            out = eng.run([Request(rid=i, prompt=p, max_new_tokens=64)
                           for i, p in enumerate(prompts)],
                          GenerationConfig())
            torch.cuda.synchronize()
            launches = read_counts(counters)
            done = out["requests"]
            assert len(done) == 8 and all(r.done_tokens == 64 for r in done)
            check_events(out["events"], done)
            check_event_stream(out["events"])
            assert out["proposer_faults"] == 0
            expect, flushes = spec_expect(launches, model.cfg, out, lens)
            assert launches == expect, (backend, spec, launches, expect)
            counts = encode_forms(launches, flushes)
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            outs[backend, spec is not None] = out
            sp = out.get("spec")
            print(f"codecs:spec[{backend}, "
                  f"{'ngram k 4' if sp else 'plain'}]: 8 requests x 64 "
                  f"tokens, {serve_line(out)}" + (
                      f"; spec steps {sp['steps']}, acceptance "
                      f"{sp['acceptance_rate']:.3f}" if sp else "")
                  + f"; launches {json.dumps(counts)}", flush=True)
        assert outs[backend, True]["spec"]["steps"] > 0
        assert rid_events(outs[backend, True]) == \
            rid_events(outs[backend, False]), \
            f"{backend}: spec streams or events differ from plain"
    return total


def phase_codecs(torch, cfg, params, counters) -> dict:
    """The baseline key codecs and per-layer cache policies at full width
    (``codec_arms``; the same weights): per arm, the ``serve`` phase's
    classic paged serving of 8 greedy requests (prompts 100-900, 64 new,
    all at t = 0) with exact launches from its polar layers and exact
    cache bytes per layer, with an eager arm for int8 and the mixed
    policy; the logit gate (kernels vs plain versions) for the mixed
    policy and the fixed grid; chunked prefill with and without the
    shared-prefix cache (6 requests) for int8 and the mixed policy; the
    ``static`` phase's two polar routes and the speculative arms
    (``codecs_spec``) under the mixed policy. Returns the launches of the
    serving runs, summed."""
    from repro_torch.models import get_model
    t_phase = time.monotonic()
    nl = cfg.num_layers
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    arms = codec_arms(cfg)
    for arm, acfg in arms.items():
        model = get_model(acfg)
        layer_bytes = paged_layer_bytes(model, params["embed"].device)
        bits = acfg.policy.avg_key_bits(nl, acfg.head_dim)
        assert abs(bits - ARM_BITS[arm]) < 1e-12, (arm, bits)
        counts, out = phase_serve(
            torch, model, params, counters, n_req=8, new=64, seed=9,
            label=f"codecs:serve[{arm}]", eager_arm=arm in ("int8", "mixed"),
            gap=0.0)
        assert out["cache_bytes"] == sum(layer_bytes)
        add(counts)
        print(f"codecs[{arm}]: {polar_layers(acfg)} of {nl} layers on the "
              f"polar kernels; {out['tokens_per_s']:.1f} tok/s, decode step "
              f"mean {out['decode_step_s_mean'] * 1e3:.3f} ms, prefill "
              f"{out['prefill_s_total']:.3f} s; cache bytes per layer "
              f"{sorted(set(layer_bytes))} (exact), {bits:.4f} logical key "
              "bits/element", flush=True)
        if arm in ("mixed", "polar-fixed"):
            rel, agree, _ = paged_logit_gate(torch, model, params)
            print(f"codecs:gate[{arm}]: prefill 512 + 16 teacher-forced "
                  f"decode steps, relative L2 logit error kernel vs plain "
                  f"max {float(rel.max()):.3e} (limit {MODEL_REL_L2}); "
                  f"argmax agreement {agree:.3f}", flush=True)
        if arm in ("int8", "mixed"):
            add(phase_prefix(torch, model, params, counters, n_req=6,
                             new=16, seed=10,
                             label=f"codecs:prefix[{arm}]"))
    add(phase_static(torch, arms["mixed"], params, counters,
                     runs=STATIC_RUNS[:2], label="codecs:static"))
    add(codecs_spec(torch, arms["mixed"], params, counters))
    print(f"codecs: phase {time.monotonic() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phases 12 and 13: the paper's configs at head_dim 128 (dense, MoE)
# ---------------------------------------------------------------------------

#: a config run of :func:`phase_configs`: the config, the layers kept (0:
#: all), the arms beyond the logit gate and the graphed 8 x 32 serving run
#: ("serve": the ``serve`` workload graphed and eager; "eager": the 8 x 32
#: run again eagerly; "graphs": :func:`phase_graphs`; "static":
#: ``ServeEngine`` on both polar routes) and the requests of its chunked
#: prefill run (0: none)
ConfigRun = tuple[str, int, tuple[str, ...], int]

#: the dense configs beyond tinyllama, each at full width in bf16;
#: llama3.1-8b, which carries the arms, with 8 of its 32 layers (whole,
#: its arms took 52 s of the run); qwen1.5-4b's 3 chunked-prefill requests
#: check the Qh-1 chunk path (6 take ~30 s of eager chunks where the host
#: is slow)
D128_CONFIGS: tuple[ConfigRun, ...] = (
    ("llama3.1-8b", 8, ("serve", "static"), 6),
    ("granite-8b", 0, (), 0),
    ("yi-9b", 0, (), 0),
    ("qwen1.5-4b", 0, (), 3),
)

#: the MoE configs: qwen2-moe-a2.7b whole (14.3 B params, 28.6 GB in
#: bf16); dbrx-132b at its published widths with 4 of its 40 layers (the
#: whole model, 132 B params, does not fit one card)
MOE_CONFIGS: tuple[ConfigRun, ...] = (
    ("qwen2-moe-a2.7b", 0, ("eager", "graphs", "static"), 3),
    ("dbrx-132b", 4, ("static",), 3),
)


def d128_counts(counts: dict, cfg) -> dict:
    """A phase's launches at a head_dim-128 config under the ``[d128]``
    rows' names: both encode forms on ``polar_encode[d128]``, every
    attention kernel at one query head per kv head (qwen1.5-4b,
    qwen2-moe-a2.7b) on the ``[d128,qh1]`` rows and at six (dbrx-132b) on
    the ``[d128,qh6]`` rows."""
    out: dict = {}
    for k, n in counts.items():
        base = k.split("[")[0]
        form = "[d128]"
        if base != "polar_encode" and cfg.q_per_kv in (1, 6):
            form = f"[d128,qh{cfg.q_per_kv}]"
        out[base + form] = out.get(base + form, 0) + n
    return out


def describe(cfg, full) -> str:
    """One config's widths, and its depth cut against ``full``."""
    cut = (f" (depth cut from {full.num_layers} to {cfg.num_layers} layers; "
           f"whole: {full.param_count() / 1e9:.2f} B params)"
           if cfg.num_layers != full.num_layers else "")
    moe = ""
    if cfg.family == "moe":
        moe = (f", {cfg.num_experts} experts of {cfg.moe_d_ff} "
               f"top-{cfg.top_k}"
               + (f" + {cfg.num_shared_experts} shared units"
                  if cfg.num_shared_experts else "")
               + (", norm_topk" if cfg.norm_topk else ""))
    if cfg.family == "vlm":
        moe = (f", {cfg.frontend_tokens} image tokens of {cfg.frontend_dim} "
               "(stubbed frontend) under a prefix-LM mask")
    if cfg.family == "hybrid":
        moe = (f", pattern {'/'.join(cfg.block_pattern)}, local window "
               f"{cfg.window}, lru_width {cfg.lru_width}")
    if cfg.family == "encdec":
        moe = (f", {cfg.frontend_tokens} audio frames of {cfg.frontend_dim} "
               "(stubbed frontend) through the encoder's full attention, "
               "cross-attention in every decoder layer")
    if cfg.family == "ssm":
        return (f"{cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
                f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} SSD heads "
                f"of {cfg.ssm_headdim}, state {cfg.ssm_state}, "
                f"{cfg.ssm_ngroups} B/C group, conv {cfg.ssm_conv}, chunk "
                f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, tied embeddings; "
                f"{cfg.param_count() / 1e9:.3f} B params bf16 (JAX's count)")
    layers = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder"
              if cfg.family == "encdec" else f"{cfg.num_layers}")
    return (f"{layers} layers{cut}, d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
            f"{cfg.head_dim}{moe}, vocab {cfg.vocab_size}, rope base "
            f"{cfg.rope_base:g}" + (", q/k/v bias" if cfg.qkv_bias else "")
            + f"; {cfg.param_count() / 1e9:.3f} B params bf16")


def phase_configs(torch, counters, runs: tuple[ConfigRun, ...], label: str,
                  dev="cuda") -> dict:
    """Each of ``runs`` one at a time in bf16 (random weights from a seeded
    generator on the card; q/k/v biases, where the config has them, drawn
    non-zero): the paged logit gate (512-token prefill + 16 decode steps,
    kernels vs plain versions, rel. L2 5e-2; for an MoE config the plain
    run replays the kernel run's expert choices, and a plain run with its
    own routing reports the share of routing decisions that differ and is
    gated on its median step, :func:`paged_logit_gate`), a graphed
    ``ContinuousBatchingEngine`` run (8 slots, max_len 1024, 8 greedy
    requests of 100-900 prompt tokens, 32 new, all at t = 0, exact
    launches) and the run's arms (:data:`ConfigRun`). Each config's
    params, engines and graph pools are freed before the next; its peak
    memory and seconds are printed, and the phase's. Returns the launches
    under the ``[d128]`` rows' names (:func:`d128_counts`)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    t_phase = time.monotonic()
    total: dict = {}
    for name, depth, arms, n_prefix in runs:
        t0 = time.monotonic()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=depth) if depth else full
        model = get_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(generator=gen, device=dev)
        if cfg.qkv_bias:
            for layer in params["layers"]:
                for b in ("bq", "bk", "bv"):
                    x = layer["attn"][b]
                    x.copy_(0.1 * torch.randn(x.shape, generator=gen,
                                              device=dev))
        rel, agree, free = paged_logit_gate(torch, model, params)
        tag = f"{label}[{name}]"
        print(f"{tag}: {describe(cfg, full)}; prefill 512 + 16 "
              f"teacher-forced decode steps, relative L2 logit error kernel "
              f"vs plain" + (" (routing replayed)" if free else "")
              + f" per step max {float(rel.max()):.3e} (prefill "
              f"{float(rel[0]):.3e}, limit {MODEL_REL_L2}); argmax agreement "
              f"{agree:.3f}" + (
                  f"; plain with its own routing: {free['flips']:.4f} of "
                  f"routing decisions differ, logit error per step median "
                  f"{float(free['free_rel'].median()):.3e} (limit "
                  f"{MODEL_REL_L2}), max {float(free['free_rel'].max()):.3e} "
                  f"(prefill {float(free['free_rel'][0]):.3e}), argmax "
                  f"agreement {free['agree']:.3f}" if free else ""),
              flush=True)
        counts: dict = {}

        def add(c):
            for k, n in d128_counts(c, cfg).items():
                counts[k] = counts.get(k, 0) + n
        c, _ = phase_serve(torch, model, params, counters, n_req=8, new=32,
                           seed=5, label=tag, eager_arm="eager" in arms,
                           gap=0.0)
        add(c)
        if "serve" in arms:
            c, _ = phase_serve(torch, model, params, counters,
                               label=f"{tag}:serve")
            add(c)
        if "graphs" in arms:
            phase_graphs(torch, model, params, label=f"{tag}:graphs")
        if "static" in arms:
            add(phase_static(torch, cfg, params, counters,
                             runs=STATIC_RUNS[:2], label=f"{tag}:static"))
        if n_prefix:
            add(phase_prefix(torch, model, params, counters, n_req=n_prefix,
                             label=f"{tag}:prefix"))
        peak = torch.cuda.max_memory_allocated()
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{tag}: peak memory {peak / 2 ** 30:.2f} GiB; "
              f"{time.monotonic() - t0:.1f} s; launches "
              f"{json.dumps(counts)}", flush=True)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    print(f"{label}: {time.monotonic() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 14: the VLM and hybrid families (head_dim 256, static engine only)
# ---------------------------------------------------------------------------

#: recurrentgemma-9b's runs: (prompt tokens, new tokens). 2560 wraps the
#: 2048-slot ring at prefill; 2016 + 63 appends wrap it during decode
HYBRID_RUNS = ((HYB_T, 16), (2016, SNEW))


def family_rows(counts: dict, cfg) -> dict:
    """A families-phase run's launches under the kernel rows' names, by
    the config's head dim. d 256 (paligemma-3b, recurrentgemma-9b): both
    encode forms on ``polar_encode[d256]``, flash prefill on
    ``[d256,prefix]`` (the VLM) or ``[d256,local]`` (the hybrid). d 64
    (seamless-m4t-medium, the forms :func:`encdec_run` measured): the
    self cache's encodes keep their rows (``polar_encode``,
    ``polar_encode[decode]``), the cross fill's go on
    ``polar_encode[d64,cross]``, the encoder's ``full`` flash prefill on
    ``[d64,full]``, the cross-attention's on ``[d64,cross]``. Every other
    launch goes on its kernel's form at the config's query heads per kv
    head (``[d256,qh8]``, ``[d256,qh16]``, ``[d64,qh1]``)."""
    d = cfg.head_dim
    forms = {256: {"polar_encode": "[d256]",
                   "flash_prefill": "[d256,prefix]" if cfg.family == "vlm"
                   else "[d256,local]"},
             64: {"polar_encode": "", "polar_encode[decode]": "[decode]",
                  "polar_encode[cross]": "[d64,cross]",
                  "flash_prefill[full]": "[d64,full]",
                  "flash_prefill[cross]": "[d64,cross]"}}.get(d, {})
    out: dict = {}
    for k, n in counts.items():
        base = k.split("[")[0]
        row = base + forms.get(k, forms.get(base, f"[d{d},qh{cfg.q_per_kv}]"))
        out[row] = out.get(row, 0) + n
    return out


def hybrid_run(torch, cfg, params, counters, prompt: int, new: int) -> dict:
    """``ServeEngine`` on recurrentgemma-9b: 8 rows x ``prompt`` tokens,
    ``new`` greedy tokens, the attention layers on 2048-slot rings (the
    decode route stays on #6 + softmax whatever ``decode_backend``). Exact
    launches: per attention layer one flash prefill, one encode of the
    ring's groups at prefill and one per flush in the decode loop, one
    #6 per decode step; no #5. The logit gate covers the prefill and every
    decode step (kernels vs plain versions, rel. L2 5e-2). Prints tok/s,
    the decode step, the ring's bytes per attention layer and the peak
    memory; returns the launches."""
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.models import hybrid as HY
    from repro_torch.serve import GenerationConfig, ServeEngine
    from repro_torch.utils import tree_bytes
    dev = params["embed"].device
    model = get_model(cfg)
    kinds = HY.layer_types(cfg)
    n_attn = kinds.count("attn")
    max_len = prompt + new
    prompts = torch.as_tensor(np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (SB, prompt)), device=dev).long()
    eng = ServeEngine(model, params, max_len=max_len)
    eng.generate({"tokens": prompts}, GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    out = eng.generate({"tokens": prompts},
                       GenerationConfig(max_new_tokens=new))
    torch.cuda.synchronize()
    got = read_counts(counters)
    steps = new - 1
    g = cfg.quant.group_size
    flushes = sum(p % g == g - 1 for p in range(prompt, prompt + steps))
    expect = {**dict.fromkeys(got, 0),
              "polar_encode": n_attn * (1 + flushes),
              "flash_prefill": n_attn, "polar_qk": n_attn * steps}
    assert got == expect, (prompt, got, expect)
    got = encode_forms(got, n_attn * flushes)
    assert out["tokens"].shape == (SB, new)
    assert out["cache_bytes_per_layer"] is None
    peak = torch.cuda.max_memory_allocated()
    state = model.init_decode_state(SB, max_len, dev)
    ring = [tree_bytes(c) for c, k in zip(state, kinds) if k == "attn"]
    rec = [tree_bytes(c) for c, k in zip(state, kinds) if k == "rec"]
    assert all(c.max_len == cfg.window for c, k in zip(state, kinds)
               if k == "attn")
    del state
    tok_t = torch.as_tensor(out["tokens"], device=dev).long()
    batch = {"tokens": prompts}
    kern, _ = _teacher_logits(torch, model, params, batch, tok_t, steps,
                              max_len)
    with plain_kernels():
        plain, _ = _teacher_logits(torch, model, params, batch, tok_t,
                                   steps, max_len)
    rel = (kern - plain).norm(dim=-1) / plain.norm(dim=-1)
    assert torch.isfinite(kern).all()
    assert float(rel.max()) <= MODEL_REL_L2, \
        f"{cfg.name} {prompt} logits drift {rel.flatten().tolist()}"
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"families[{cfg.name}]: {SB} rows x {prompt}-token prompts "
          f"(window {cfg.window}: the ring " + (
              "wraps at prefill" if prompt > cfg.window else
              f"wraps in decode at position {cfg.window}")
          + f"), {new} greedy tokens: prefill {out['prefill_s']:.3f} s, "
          f"decode {out['decode_s']:.3f} s = {out['tokens_per_s']:.1f} tok/s,"
          f" decode step {out['decode_s'] / max(steps, 1) * 1e3:.3f} ms; "
          f"ring cache {ring[0]} B per attention layer ({len(ring)} layers,"
          f" capacity {cfg.window}), RG-LRU state {rec[0]} B per recurrent "
          f"layer ({len(rec)}); peak {peak / 2 ** 30:.2f} GiB; rel. L2 "
          f"logits vs plain over prefill + {steps} steps max "
          f"{float(rel.max()):.3e} (prefill {float(rel[0].max()):.3e}, "
          f"limit {MODEL_REL_L2}); argmax agreement {agree:.4f}; launches "
          f"{json.dumps(got)}", flush=True)
    return got


def _polar_cache_bytes(b, hkv, t, d, g=G) -> int:
    """One polar cache of ``b`` rows x ``hkv`` kv heads x ``t`` tokens
    (a multiple of g) x head dim ``d``, bf16 values: a code byte per
    pair, four fp32 stat rows per group, the bf16 residual group, the
    value rows and the int32 length."""
    rows, p = b * hkv * t, d // 2
    return rows * p + 4 * b * hkv * (t // g) * p * 4 + b * hkv * g * d * 2 \
        + rows * d * 2 + 4


def encdec_run(torch, cfg, params, counters) -> dict:
    """``ServeEngine`` on seamless-m4t-medium, speech-to-text: 8 rows, 1024
    stubbed audio frames of 160 seeded random features, a 16-token
    decoder prompt, 128 greedy tokens, max_len 256 (the self cache
    flushes its first group at position 127, inside the decode loop), on
    both polar routes. Exact launches: the encoder's ``full`` flash
    prefill once an encoder layer, and per decoder layer one causal
    flash prefill (the prompt), one ``full`` (the cross-attention over
    the memory), one encode of the cross cache's 8 groups and one flush
    encode; per decoder layer and step, the self decode on the run's
    route (#5 on ``"paged_fused"``, every launch on its split body; #6
    on ``"jnp"``) and #6 on the cross cache. The logit gate covers the
    prefill and every decode step; the decode state's bytes (self +
    cross caches) are asserted exactly. Each form's launches are measured
    in the run (:func:`booked_launches`): the encodes inside
    ``cross_attention_cache`` (``polar_encode[cross]``), the rest of the
    prefill's (``polar_encode``, the self cache's fill) and those after it
    (``polar_encode[decode]``, the flushes); the ``full`` flash prefills
    inside ``encode`` (``flash_prefill[full]``) and inside the
    cross-attention's ``attention_train`` (``flash_prefill[cross]``).
    Returns those counts, summed over both routes (:func:`family_rows`
    names their rows)."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.models import attn_block as AB
    from repro_torch.models import encdec as ED
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, ServeEngine
    dev = params["embed"].device
    nl, ne, steps = cfg.num_layers, cfg.encoder_layers, ED_NEW - 1
    always = lambda *a, **kw: True  # noqa: E731
    spans = {"prefill": (ED, "prefill_fn", always),
             "encoder": (ED, "encode", always),
             "cross fill": (AB, "cross_attention_cache", always),
             "cross": (AB, "attention_train",
                       lambda *a, memory=None, **kw: memory is not None)}
    prompts = torch.as_tensor(np.random.default_rng(ED_TEXT).integers(
        0, cfg.vocab_size, (SB, ED_TEXT)), device=dev).long()
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(5)
    batch = {"tokens": prompts,
             "frames": torch.randn((SB, cfg.frontend_tokens,
                                    cfg.frontend_dim), generator=fgen,
                                   device=dev)}
    g = cfg.quant.group_size
    flushes = sum(p % g == g - 1 for p in range(ED_TEXT, ED_TEXT + steps))
    state_bytes = nl * (
        _polar_cache_bytes(SB, cfg.num_kv_heads, ED_MAX, cfg.head_dim, g)
        + _polar_cache_bytes(SB, cfg.num_kv_heads,
                             -(-cfg.frontend_tokens // g) * g, cfg.head_dim,
                             g))
    total: dict = {}
    toks = {}
    for backend in ("jnp", "paged_fused"):
        model = get_model(dataclasses.replace(cfg, decode_backend=backend))
        eng = ServeEngine(model, params, max_len=ED_MAX)
        eng.generate(batch, GenerationConfig(max_new_tokens=2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        with booked_launches(counters, spans) as spent:
            out = eng.generate(batch,
                               GenerationConfig(max_new_tokens=ED_NEW))
        torch.cuda.synchronize()
        got = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        fused = backend == "paged_fused"
        zero = dict.fromkeys(got, 0)
        expect = {**zero, "polar_encode": nl * (1 + flushes),
                  "flash_prefill": nl, "flash_prefill[full]": ne + nl,
                  "polar_qk": nl * steps * (1 if fused else 2)}
        if fused:
            expect["polar_attention"] = nl * steps
        assert got == expect, (backend, got, expect)
        want = {"prefill": {**zero, "polar_encode": nl, "flash_prefill": nl,
                            "flash_prefill[full]": ne + nl},
                "encoder": {**zero, "flash_prefill[full]": ne},
                "cross fill": {**zero, "polar_encode": nl},
                "cross": {**zero, "flash_prefill[full]": nl}}
        assert spent == want, (backend, spent, want)
        assert pak.launches_split == got["polar_attention"], \
            (backend, "polar_attention off the split body")
        pre = spent["prefill"]["polar_encode"]
        fill = spent["cross fill"]["polar_encode"]
        measured = {"polar_encode[cross]": fill,
                    "polar_encode": pre - fill,
                    "polar_encode[decode]": got["polar_encode"] - pre,
                    "flash_prefill[full]":
                        spent["encoder"]["flash_prefill[full]"],
                    "flash_prefill[cross]":
                        spent["cross"]["flash_prefill[full]"],
                    "flash_prefill": got["flash_prefill"],
                    "polar_attention": got["polar_attention"],
                    "polar_qk": got["polar_qk"]}
        for k, n in measured.items():
            total[k] = total.get(k, 0) + n
        assert out["tokens"].shape == (SB, ED_NEW)
        assert out["cache_bytes_per_layer"] is None
        assert out["cache_bytes"] == state_bytes, \
            (out["cache_bytes"], state_bytes)
        toks[backend] = out["tokens"]
        tok_t = torch.as_tensor(out["tokens"], device=dev).long()
        kern, _ = _teacher_logits(torch, model, params, batch, tok_t, steps,
                                  ED_MAX)
        with plain_kernels():
            plain, _ = _teacher_logits(torch, model, params, batch, tok_t,
                                       steps, ED_MAX)
        rel = (kern - plain).norm(dim=-1) / plain.norm(dim=-1)
        assert torch.isfinite(kern).all()
        assert float(rel.max()) <= MODEL_REL_L2, \
            f"{cfg.name} {backend} logits drift {rel.flatten().tolist()}"
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        del kern, plain
        print(f"families[{cfg.name}:{backend}]: {SB} rows x "
              f"{cfg.frontend_tokens} frames + {ED_TEXT}-token prompts, "
              f"{ED_NEW} greedy tokens, max_len {ED_MAX}: prefill (encoder "
              f"included) {out['prefill_s']:.3f} s, decode "
              f"{out['decode_s']:.3f} s = {out['tokens_per_s']:.1f} tok/s, "
              f"step {out['decode_s'] / steps * 1e3:.3f} ms; decode state "
              f"{out['cache_bytes']} B (self + cross caches, "
              f"{out['cache_bytes'] // nl} B per decoder layer); peak "
              f"{peak / 2 ** 30:.2f} GiB; rel. L2 logits vs plain over "
              f"prefill + {steps} steps max {float(rel.max()):.3e} (prefill "
              f"{float(rel[0].max()):.3e}, limit {MODEL_REL_L2}); argmax "
              f"agreement {agree:.4f}; launches "
              f"{json.dumps(family_rows(measured, cfg))}", flush=True)
    same = toks["jnp"] == toks["paged_fused"]
    print(f"families[{cfg.name}]: greedy tokens of the score-only and fused "
          f"self-decode routes agree on {float(same.mean()):.4f} of "
          f"{same.size}", flush=True)
    return total


#: mamba2-2.7b's run: 8 rows x 1000-token prompts (4 SSD chunks of 256, the
#: last ragged), 64 greedy tokens; the duality gate's k decode steps
SSM_T, SSM_NEW, SSM_K = 1000, 64, 16
#: mamba2's bf16 duality limit (rel. L2 of the last logits, the max over
#: the rows): above the sound reading (5.643e-2 on an H100), below both
#: controls' of :func:`ssm_run` (a bf16 SSD state between decode steps
#: read 6.148e-2, the prefill conv rounded at JAX's points 7.624e-2),
#: which the phase asserts above it in every run
SSM_BF16_TOL = 5.9e-2


def _duality(torch, model, params, ext, t0: int, step_hook=None) -> dict:
    """The engine's two computations of the last logits over ``ext`` (B,
    t0 + k): a prefill of t0 tokens (the chunked SSD) then k decode steps
    (the recurrence, each followed by ``step_hook`` on the state where
    one is given), against a prefill of all t0 + k. Returns the rel. L2
    of the logits per row, their argmax agreement and the rel. L2 of the
    two final states (conv windows, SSD states)."""
    dev = ext.device
    b = ext.shape[0]
    lg, rec = model.prefill(params, {"tokens": ext[:, :t0]},
                            model.init_decode_state(b, 0, dev))
    for i in range(t0, ext.shape[1]):
        lg, rec = model.decode(params, rec, ext[:, i])
        if step_hook is not None:
            rec = step_hook(rec)
    want, chunked = model.prefill(params, {"tokens": ext},
                                  model.init_decode_state(b, 0, dev))
    assert torch.isfinite(lg).all() and torch.isfinite(want).all()
    lg, want = lg.float(), want.float()

    def state_rel(i):
        a = torch.stack([s[i].float() for s in rec])
        r = torch.stack([s[i].float() for s in chunked])
        return float((a - r).norm() / r.norm())
    return {"rel": (lg - want).norm(dim=-1) / want.norm(dim=-1),
            "agree": float((lg.argmax(-1) == want.argmax(-1)).float().mean()),
            "conv": state_rel(0), "ssd": state_rel(1), "steps": lg,
            "chunked": want}


def _conv_rounded_apart(u, w, b):
    """The SSD prefill conv with JAX's rounding points (its
    ``_causal_conv``): the conv, the bias add and the SiLU each rounded to
    u's dtype. A control of :func:`ssm_run`'s bf16 gate: the port rounds
    once, as the decode step does."""
    import torch.nn.functional as F
    wn, c = w.shape
    x = F.pad(u.transpose(1, 2), (wn - 1, 0))
    out = F.conv1d(x, w.t()[:, None, :].to(u.dtype), groups=c)
    return F.silu(out.transpose(1, 2) + b.to(u.dtype))


def ssm_run(torch, cfg, params, counters) -> dict:
    """``ServeEngine`` on mamba2-2.7b: 8 rows x 1000 tokens, 64 greedy
    tokens. The family runs no hand-written kernel (its SSD scan is jnp
    in JAX, plain PyTorch here): every launch count must stay 0. The
    logit gate compares the engine's two computations of the same
    function (:func:`_duality`): the last logits of a prefill of T + k
    tokens (the chunked SSD) against a prefill of T then k decode steps
    (the recurrence), k = 16. On the same weights cast to fp32 they must
    agree within rel. L2 1e-4: the SSD duality itself. In bf16 they must
    agree within :data:`SSM_BF16_TOL`, and two controls, each a bf16-only
    fault in one of the two computations, must not: the SSD state
    rounded to bf16 after every decode step, and the prefill conv
    rounded at JAX's points (conv, bias add and SiLU apart,
    :func:`_conv_rounded_apart`). The two final states and the bf16
    computations' distance from their fp32 twins are reported. The
    decode state's bytes are asserted exactly: per row and layer (W - 1)
    x conv_dim conv rows in bf16 and H x P x N fp32 SSD state."""
    import dataclasses
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.models import mamba2 as M2
    from repro_torch.serve import GenerationConfig, ServeEngine
    dev = params["embed"].device
    model = get_model(cfg)
    dm = M2.dims(cfg)
    prompts = torch.as_tensor(np.random.default_rng(SSM_T).integers(
        0, cfg.vocab_size, (SB, SSM_T)), device=dev).long()
    eng = ServeEngine(model, params, max_len=SSM_T + SSM_NEW)
    eng.generate({"tokens": prompts}, GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    out = eng.generate({"tokens": prompts},
                       GenerationConfig(max_new_tokens=SSM_NEW))
    torch.cuda.synchronize()
    got = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    assert got == dict.fromkeys(got, 0), got
    per_row = cfg.num_layers * ((dm.conv_w - 1) * dm.conv_dim * 2
                                + dm.nheads * dm.headdim * dm.dstate * 4)
    assert out["cache_bytes"] == SB * per_row, (out["cache_bytes"], per_row)
    assert out["tokens"].shape == (SB, SSM_NEW)
    steps = SSM_NEW - 1
    ext = torch.cat([prompts, torch.as_tensor(
        out["tokens"][:, :SSM_K], device=dev).long()], dim=1)
    bf = _duality(torch, model, params, ext, SSM_T)
    p32 = {k: v.float() for k, v in params.items() if k != "layers"}
    p32["layers"] = [{k: v.float() for k, v in lp.items()}
                     for lp in params["layers"]]
    f32 = _duality(torch, get_model(dataclasses.replace(
        cfg, dtype="float32")), p32, ext, SSM_T)
    del p32
    # each bf16 computation against its fp32 twin, reported
    noise = max(float(((bf[k] - f32[k]).norm(dim=-1)
                       / f32[k].norm(dim=-1)).max())
                for k in ("steps", "chunked"))
    gates = {"fp32": (f32, FP32_TOL), "bf16": (bf, SSM_BF16_TOL)}
    for kind, (d, limit) in gates.items():
        assert float(d["rel"].max()) <= limit, \
            f"{cfg.name} {kind} duality drift {d['rel'].tolist()}, {limit}"
    controls = {"SSD state in bf16 between steps": _duality(
        torch, model, params, ext, SSM_T,
        step_hook=lambda rec: [(c, s.bfloat16().float()) for c, s in rec])}
    with mock.patch.object(M2, "_causal_conv", _conv_rounded_apart):
        controls["prefill conv rounded at JAX's points"] = _duality(
            torch, model, params, ext, SSM_T)
    for name, d in controls.items():
        assert float(d["rel"].max()) > SSM_BF16_TOL, \
            f"{cfg.name}: the bf16 duality gate passes the control " \
            f"{name!r}: {d['rel'].tolist()}"
    print(f"families[{cfg.name}]: {SB} rows x {SSM_T}-token prompts "
          f"({-(-SSM_T // cfg.ssm_chunk)} SSD chunks of {cfg.ssm_chunk}, the "
          f"last ragged), {SSM_NEW} greedy tokens: prefill "
          f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tok/s, step "
          f"{out['decode_s'] / steps * 1e3:.3f} ms; decode state "
          f"{out['cache_bytes']} B ({per_row} B per row, "
          f"{per_row // cfg.num_layers} per row and layer); peak "
          f"{peak / 2 ** 30:.2f} GiB; duality gate, prefill {SSM_T} + "
          f"{SSM_K} steps vs prefill {SSM_T + SSM_K}: " + "; ".join(
              f"{kind}: rel. L2 of the last logits max "
              f"{float(d['rel'].max()):.3e} (limit {limit}), argmax "
              f"agreement {d['agree']:.4f}, rel. L2 of the states: conv "
              f"windows {d['conv']:.3e}, SSD states {d['ssd']:.3e}"
              for kind, (d, limit) in gates.items())
          + "; controls, each above the bf16 limit: " + "; ".join(
              f"{name}: max {float(d['rel'].max()):.3e}"
              for name, d in controls.items())
          + f"; bf16 against fp32 max {noise:.3e}"
          + "; no kernel launched", flush=True)
    return {}


#: the families phase's configs, one at a time
FAMILY_CONFIGS = ("paligemma-3b", "recurrentgemma-9b", "seamless-m4t-medium",
                  "mamba2-2.7b")


def phase_families(torch, counters, dev="cuda") -> dict:
    """paligemma-3b, recurrentgemma-9b, seamless-m4t-medium and
    mamba2-2.7b whole, at full width in bf16 on the static engine (seeded
    random weights on the card, one model at a time, params freed
    between): paligemma's ``phase_static`` on both polar routes (8 rows x
    256 image + 744 text tokens, 64 new, the logit gate over every decode
    step; every fused launch on #5's split body), recurrentgemma's
    :data:`HYBRID_RUNS` (:func:`hybrid_run`), seamless's
    :func:`encdec_run` and mamba2's :func:`ssm_run` (none). Returns the
    launches under the kernel rows' names (:func:`family_rows`)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    t_phase = time.monotonic()
    total: dict = {}
    for name in FAMILY_CONFIGS:
        t0 = time.monotonic()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(name)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = get_model(cfg).init(generator=gen, device=dev)
        print(f"families[{name}]: {describe(cfg, cfg)}", flush=True)
        if cfg.family == "vlm":
            runs = [phase_static(torch, cfg, params, counters,
                                 runs=STATIC_RUNS[:2],
                                 label=f"families[{name}]:static",
                                 gate_steps=SNEW - 1)]
        elif cfg.family == "hybrid":
            runs = [hybrid_run(torch, cfg, params, counters, t, n)
                    for t, n in HYBRID_RUNS]
        elif cfg.family == "encdec":
            runs = [encdec_run(torch, cfg, params, counters)]
        else:
            runs = [ssm_run(torch, cfg, params, counters)]
        for r in runs:
            for k, n in family_rows(r, cfg).items():
                total[k] = total.get(k, 0) + n
        peak = torch.cuda.max_memory_allocated()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"families[{name}]: peak memory {peak / 2 ** 30:.2f} GiB; "
              f"{time.monotonic() - t0:.1f} s", flush=True)
    print(f"families: {time.monotonic() - t_phase:.1f} s; launches "
          f"{json.dumps(total)}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 16: the training path
# ---------------------------------------------------------------------------

#: the full-width training run: tinyllama-1.1b, 8 rows x 512 tokens (+1),
#: fp32 masters and bf16 compute, block remat, the head's loss in chunks of
#: 512, TRAIN_STEPS steps on the synthetic stream
TRAIN_CONFIG, TRAIN_B, TRAIN_T, TRAIN_STEPS = "tinyllama-1.1b", 8, 512, 40
TRAIN_STEP_CFG = dict(peak_lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS,
                      remat="block", ce_chunk=512)
#: the other five families at their smoke reductions (head_dim 32, fp32)
TRAIN_FAMILIES = ("qwen2-moe-a2.7b", "paligemma-3b", "recurrentgemma-9b",
                  "seamless-m4t-medium", "mamba2-2.7b")
TRAIN_SMOKE = dict(batch=8, seq=64, steps=40,
                   step_cfg=dict(peak_lr=2e-3, warmup_steps=5,
                                 total_steps=40))
#: relative L2 of flash_attention's dq / dk / dv against autograd through
#: reference_attention in fp32, by input dtype
GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
LSE_TOL = 1e-3         # abs, the kernel's lse against the plain version's
FALL = 0.05            # loss fall, mean of the first 5 steps to the last 5
TRAIN_LOSS_RTOL = 1e-3         # bf16 full width: kernel vs plain, step 1
TRAIN_GNORM_RTOL = 2e-2
SMOKE_LOSS_RTOL = 1e-4         # fp32 smoke width: kernel vs plain, step 1


def check_train_attention(torch, dev, gen, flush) -> dict:
    """#3 with the log-sum-exp at the training shape (tinyllama-1.1b's 32
    / 4 heads x 512 tokens x d 64, 8 rows, causal, bf16): ``out`` within
    one bf16 step (2^-7) of the plain version (the chunked online-softmax
    forward), ``lse`` within 1e-3, and ``out`` bit-equal to the serving
    launch without ``lse``. Timed beside the plain version and SDPA."""
    from repro_torch.kernels import flash_prefill as fpk
    h, hkv, b, t = 32, HKV, TRAIN_B, TRAIN_T
    q = torch.randn((b, h, t, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, hkv, t, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out, lse = fpk.flash_prefill(q, k, v, return_lse=True)
    ref, ref_lse = fpk.flash_prefill_plain(q, k, v, return_lse=True)
    serve = fpk.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_RTOL,
                               atol=BF16_RTOL)
    lse_err = float((lse - ref_lse).abs().max())
    assert lse_err <= LSE_TOL, f"lse off by {lse_err}"
    assert torch.equal(out, serve), "the lse launch moved the output"
    err = float((out.float() - ref.float()).abs().max())
    ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v, return_lse=True),
                 flush=flush)
    serve_ms = time_ms(torch, lambda: fpk.flash_prefill(q, k, v),
                       flush=flush)
    plain_ms = time_ms(torch, lambda: fpk.flash_prefill_plain(
        q, k, v, return_lse=True), iters=10, flush=flush,
        lead_cycles=PLAIN_LEAD)
    ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q, ke, ve, is_causal=True),
                     flush=flush)
    nbytes = (2 * h + 2 * hkv) * b * t * D * 2 + b * h * t * 4
    b_ms = bound(nbytes, 4.0 * b * h * D * (t * (t + 1) / 2), "bf16")
    print(f"train[kernel]: flash_prefill with lse {b} x {h} heads ({hkv} "
          f"kv) x {t} x {D} bf16, causal: {ms:.4f} ms (without lse "
          f"{serve_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {b_ms[0]:.4f} ms {b_ms[1]}); out err {err:.3g}, lse "
          f"err {lse_err:.3g}", flush=True)
    return _form_row(
        "flash_prefill", "[lse]", "flash_prefill.cu",
        "src/repro/kernels/flash_prefill.py:77", max(err, lse_err), ms,
        plain_ms, b_ms, lib_ms, "SDPA",
        f"{b} x {h} heads ({hkv} kv) x {t} tokens x {D} bf16, causal, "
        "+ lse (B, H, T) fp32")


def check_train_grads(torch, dev, gen) -> None:
    """dq, dk, dv of ``flash_attention`` (the kernel's forward with lse,
    the ported backward) against autograd through ``reference_attention``
    on the same values in fp32: relative L2 within ``GRAD_TOL`` in the
    causal, prefix, local and full (Tq != Tk) modes, fp32 and bf16."""
    from repro_torch.core.attention import flash_attention, \
        reference_attention
    cases = (("causal", 256, 256, 0), ("prefix", 256, 256, 0),
             ("local", 256, 256, 96), ("full", 160, 320, 0))
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for mode, tq, tk, window in cases:
            q = torch.randn((2, 8, tq, D), generator=gen, device=dev).to(dt)
            k, v = (torch.randn((2, 2, tk, D), generator=gen,
                                device=dev).to(dt) for _ in range(2))
            g = torch.randn((2, 8, tq, D), generator=gen, device=dev)
            pl = (torch.tensor([100, 37], dtype=torch.int32, device=dev)
                  if mode == "prefix" else None)
            kw = dict(mode=mode, window=window, prefix_len=pl)
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(flash_attention(*xs, **kw), xs,
                                      g.to(dt))
            rs = [x.float().requires_grad_(True) for x in (q, k, v)]
            want = torch.autograd.grad(reference_attention(*rs, **kw), rs, g)
            rel = max(float(torch.linalg.vector_norm(a.float() - w)
                            / torch.linalg.vector_norm(w))
                      for a, w in zip(got, want))
            name = str(dt).split(".")[1]
            assert rel <= GRAD_TOL[name], f"{name} {mode}: rel L2 {rel}"
            worst[f"{name} {mode}"] = rel
    print("train[grads]: flash_attention dq/dk/dv rel. L2 vs autograd "
          "through reference_attention: " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()), flush=True)


def _first_step_gate(label, kern, plain, rtol_loss, rtol_gnorm=None) -> str:
    """The kernel run's first-step metrics against the plain run's."""
    rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    assert rel <= rtol_loss, f"{label}: step-1 loss rel {rel}"
    out = f"step-1 loss {kern['loss']:.6f} vs plain {plain['loss']:.6f} " \
          f"(rel {rel:.2e})"
    if rtol_gnorm is not None:
        rg = abs(kern["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
        assert rg <= rtol_gnorm, f"{label}: step-1 grad_norm rel {rg}"
        out += f", grad_norm {kern['grad_norm']:.5f} vs " \
               f"{plain['grad_norm']:.5f} (rel {rg:.2e})"
    return out


def train_run(torch, cfg, dev, batches, step_cfg, timed=False) -> dict:
    """One plain step (every kernel wrapper swapped for its plain version)
    and ``len(batches)`` kernel steps from the same initial state: the
    loss falls by more than ``FALL``; returns the first steps' metrics,
    the losses and, with ``timed``, each step's ms and the ported flash
    backward's ms in it (CUDA events)."""
    from repro_torch.core import attention as att
    from repro_torch.models import get_model
    from repro_torch.train import StepConfig, init_train_state, \
        make_train_step
    model = get_model(cfg)
    step = make_train_step(model, None, StepConfig(**step_cfg))
    state = init_train_state(model, 0, device=dev)
    with plain_kernels():
        _, m = step(state, batches[0])
    plain = {k: float(v) for k, v in m.items()}
    metrics, steps, bwd = [], [], []
    real_bwd = att.flash_backward

    def timed_bwd(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*a, **kw)
        ev[1].record()
        bwd[-1].append(ev)
        return out
    with mock.patch.object(att, "flash_backward",
                           timed_bwd if timed else real_bwd):
        for b in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            bwd.append([])
            ev[0].record()
            state, m = step(state, b)
            ev[1].record()
            steps.append(ev)
            metrics.append(m)
    torch.cuda.synchronize()
    losses = [float(m["loss"]) for m in metrics]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first - FALL, f"{cfg.name}: loss {first} -> {last}"
    out = {"plain": plain, "kern": {k: float(v) for k, v in
                                    metrics[0].items()},
           "losses": losses, "first5": first, "last5": last}
    if timed:
        out["step_ms"] = [a.elapsed_time(b) for a, b in steps]
        out["bwd_ms"] = [sum(a.elapsed_time(b) for a, b in evs)
                         for evs in bwd]
    return out


def train_resume(torch, dev) -> str:
    """``python -m repro_torch.launch.train --smoke --steps 12`` in a
    subprocess (on the card, its default; checkpoints at steps 6 and 12
    under a temporary directory), then a ``Trainer`` here restores its
    step-12 checkpoint and trains to step 16 (the launcher's settings for
    ``--steps 16``)."""
    import os
    import signal
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import get_model
    from repro_torch.train import StepConfig, Trainer, TrainerConfig
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--steps", "12", "--batch", "8", "--seq", "64", "--ckpt", d]
            + ([] if dev == "cuda" else ["--device", str(dev)]),
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        assert latest_step(d) == 12, os.listdir(d)
        sub = proc.stdout.strip().splitlines()[-1]
        cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
        ds = SyntheticLMDataset(cfg, global_batch=8, seq_len=64, seed=0)
        logs = []
        original = signal.getsignal(signal.SIGTERM)
        try:
            tr = Trainer(get_model(cfg), ds,
                         TrainerConfig(total_steps=16, checkpoint_every=8,
                                       checkpoint_dir=d, log_every=100),
                         StepConfig(peak_lr=1e-3, warmup_steps=5,
                                    total_steps=16),
                         log_fn=logs.append, device=dev)
            res = tr.run()
        finally:
            signal.signal(signal.SIGTERM, original)
        assert logs[0] == "[trainer] restored step=12", logs
        assert res["final_step"] == 16 and len(res["losses"]) == 4
        assert ds.state.step == 16 and latest_step(d) == 16
    return (f"subprocess: {sub!r}; resumed at 12, losses "
            f"{[round(x, 4) for x in res['losses']]}; "
            f"{time.monotonic() - t0:.1f} s")


def phase_train(torch, counters, dev="cuda") -> tuple[dict, dict]:
    """The training path on the card: #3 with its log-sum-exp at the
    training shape (the ``flash_prefill[lse]`` row) and the gradients of
    ``flash_attention``, both beside their references (launches not
    counted); then, counted, tinyllama-1.1b at full width through
    ``make_train_step`` for ``TRAIN_STEPS`` steps (its first step beside
    a plain run's; 2 x 22 #3 launches a step under block remat), the five
    other families at smoke width, and the launcher in a subprocess with
    a resume here. Returns (launches, the kernel row)."""
    import gc
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import SyntheticLMDataset
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    row = check_train_attention(torch, dev, gen, flush)
    check_train_grads(torch, dev, gen)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(TRAIN_CONFIG)
    ds = SyntheticLMDataset(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T,
                            seed=0)
    batches = [ds.next_batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.monotonic()
    r = train_run(torch, cfg, dev, batches, TRAIN_STEP_CFG, timed=True)
    counts = read_counts(counters)
    per_step = counts["flash_prefill[lse]"] / TRAIN_STEPS
    assert per_step == 2 * cfg.num_layers, counts
    assert not {k: n for k, n in counts.items()
                if n and k != "flash_prefill[lse]"}, counts
    steady = sorted(r["step_ms"][1:])
    step_ms = steady[len(steady) // 2]
    share = sum(r["bwd_ms"][1:]) / sum(r["step_ms"][1:])
    gate = _first_step_gate(cfg.name, r["kern"], r["plain"],
                            TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL)
    print(f"train[{cfg.name}]: {describe(cfg, cfg)}; fp32 masters, bf16 "
          f"compute, {TRAIN_B} x {TRAIN_T} tokens, block remat, ce_chunk "
          f"{TRAIN_STEP_CFG['ce_chunk']}, {TRAIN_STEPS} steps: loss "
          f"{r['first5']:.4f} -> "
          f"{r['last5']:.4f} (mean of the first / last 5); {gate}; step "
          f"{step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, CUDA "
          f"events), {TRAIN_B * TRAIN_T / step_ms * 1e3:.0f} tokens/s; "
          f"flash backward {share * 100:.1f} % of a step; #3 launches a "
          f"step {per_step:.0f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    del r, batches
    gc.collect()
    torch.cuda.empty_cache()

    sm = TRAIN_SMOKE
    for name in TRAIN_FAMILIES:
        t0 = time.monotonic()
        fcfg = reduce_for_smoke(get_config(name))
        seq = sm["seq"] + (fcfg.frontend_tokens if fcfg.family == "vlm"
                           else 0)
        fds = SyntheticLMDataset(fcfg, global_batch=sm["batch"],
                                 seq_len=seq, seed=0)
        r = train_run(torch, fcfg, dev,
                      [fds.next_batch() for _ in range(sm["steps"])],
                      sm["step_cfg"])
        gate = _first_step_gate(name, r["kern"], r["plain"], SMOKE_LOSS_RTOL)
        print(f"train[{name}]: smoke width ({fcfg.num_layers} layers, "
              f"d_model {fcfg.d_model}, head_dim {fcfg.head_dim}, fp32), "
              f"{sm['batch']} x {seq} tokens, {sm['steps']} steps: loss "
              f"{r['first5']:.4f} -> {r['last5']:.4f}; {gate}; "
              f"{time.monotonic() - t0:.1f} s", flush=True)
    print(f"train[launch]: {train_resume(torch, dev)}", flush=True)
    counts = read_counts(counters)
    print(f"train: launches {json.dumps(counts)}", flush=True)
    return {"flash_prefill[lse]": counts["flash_prefill[lse]"]}, row


# ---------------------------------------------------------------------------
# phase 15: head-sharded paged serving on torch.distributed (DESIGN.md §17)
# ---------------------------------------------------------------------------

#: the mesh phase's spawned worlds: (config, depth (0: whole), world size,
#: smoke reduction) — llama3.1-8b at full width over two gloo ranks (4 of
#: its 8 KV heads a rank), and the smoke tinyllama (2 KV heads) over four,
#: the GQA fallback: every rank holds the whole pools
MESH_WORLDS = (("llama3.1-8b", 8, 2, False), ("tinyllama-1.1b", 0, 4, True))
#: a rank's seconds to come up, serve and write its results
MESH_RANK_TIMEOUT_S = 150


def _mesh_workload(cfg, smoke: bool, seed: int = 11) -> dict:
    """The mesh phase's requests, all at t = 0 so that two engines (mesh
    and meshless) make the same schedule: ``classic`` — 8 greedy requests
    of 100-900 prompt tokens (20-100 for the smoke config), 32 new;
    ``prefix`` (not for the smoke config) — 6 requests sharing a 512-token
    system prompt + 32-300-token suffixes, rid 0 at t = 0 and the rest at
    t = 5 s (so rid 0's pages are registered first), served chunked (256)
    with the prefix cache. Lists of (rid, prompt, new, arrival)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi, n = (20, 100, 4) if smoke else (100, 900, 8)
    out = {"classic": [
        (i, rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32),
         16 if smoke else 32, 0.0)
        for i, t in enumerate(rng.integers(lo, hi + 1, n))]}
    if not smoke:
        system = rng.integers(0, cfg.vocab_size, (512,)).astype(np.int32)
        out["prefix"] = [
            (i, np.concatenate([system, rng.integers(
                0, cfg.vocab_size, (int(t),)).astype(np.int32)]), 32,
             0.0 if i == 0 else 5.0)
            for i, t in enumerate(rng.integers(32, 301, 6))]
    return out


def _mesh_model(torch, name: str, depth: int, smoke: bool, dev):
    """(config, model, params): seeded random weights on ``dev``, the
    same on every process."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    cfg = get_config(name)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    elif depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = get_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, model, model.init(generator=gen, device=dev)


def mesh_serve(torch, model, params, counters, reqs, dev, mesh=None,
               smoke=False, **kw) -> dict:
    """Serve ``reqs`` ((rid, prompt, new, arrival)) on one engine (8 slots,
    max_len 1024; 4 and 128 for a ``smoke`` workload), warmed up first, with
    each decode step's logits recorded (a speculative verify's argmaxes
    and accept counts: it returns no logits): streams, per-request
    events, logits, launches, cache bytes, whether decode replayed graphs,
    the head block, the mean decode step and the result's decode steps,
    prefills, spec and run-ahead entries."""
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    eng = ContinuousBatchingEngine(
        model, params, max_slots=4 if smoke else 8,
        max_len=128 if smoke else 1024, device=dev, mesh=mesh, **kw)
    eng.warmup([len(p) for _, p, _, _ in reqs])
    logits = []
    graphs = eng.core._graphs
    real, real_verify = graphs.step, graphs.verify

    def step(*a, **k):
        out = real(*a, **k)
        logits.append(out[0].clone())   # a replay's output: copy it
        return out

    def verify(*a, **k):
        # a verify returns no logits: its argmaxes and accept counts
        preds, n_acc = real_verify(*a, **k)
        logits.append(torch.cat([preds, n_acc[:, None]], 1).clone())
        return preds, n_acc
    with mock.patch.object(graphs, "step", step), \
            mock.patch.object(graphs, "verify", verify):
        _sync_dev(torch, dev)
        reset_counts(counters)
        out = eng.run([Request(rid=rid, prompt=p, max_new_tokens=n,
                               arrival_time=t) for rid, p, n, t in reqs],
                      GenerationConfig())
        _sync_dev(torch, dev)
        launches = read_counts(counters)
    done = out["requests"]
    assert len(done) == len(reqs) and all(
        r.done_tokens == n for r, (_, _, n, _) in zip(
            sorted(done, key=lambda r: r.rid), reqs))
    check_events(out["events"], done)
    lengths = sum(c.lengths.numel() * 4 for c in eng.core.state)
    return {"streams": {r.rid: list(r.out_tokens) for r in done},
            "events": rid_events(out), "logits": logits,
            "launches": launches, "pool_bytes": out["cache_bytes"] - lengths,
            "graphs": out["graphs"], "head_shard": out["head_shard"],
            "step_ms": out["decode_step_s_mean"] * 1e3,
            "decode_steps": out["decode_steps"], "wall_s": out["wall_s"],
            "result": {k: out.get(k) for k in ("decode_steps", "prefills",
                                               "spec", "runahead")}}


def _sync_dev(torch, dev) -> None:
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


#: the mesh phase's speculative arms: ngram, k 4
MESH_SPEC_K = 4
#: the static engine's decode routes under a mesh: #5 (the fused route)
#: and #6 (the score route)
MESH_STATIC_ROUTES = (("paged_fused", "polar_attention"),
                      ("jnp", "polar_qk"))
#: decode steps whose logits a spawned rank keeps whole (every step's
#: logits also as a digest of their bytes)
MESH_KEEP_STEPS = 8


def _digest(torch, x) -> str:
    """A digest of ``x``'s bytes: equal digests, bit-equal tensors."""
    import hashlib
    return hashlib.sha1(x.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def mesh_static(torch, cfg, params, counters, dev, mesh=None,
                keep=None) -> dict:
    """``ServeEngine`` on the static phase's shape (8 rows x 1000-token
    prompts, 64 greedy new tokens, max_len 1152) per decode route of
    :data:`MESH_STATIC_ROUTES`, on ``mesh`` when one is given (the engine
    installs ``serving_rules``), after a 2-token warm-up. Per route: tokens, the prefill's and every decode step's
    logits (``keep``: only the first ``keep`` steps' whole, every step's
    digest), launches, the linear caches' bytes (the whole length scalars
    left out), the head block and the decode seconds."""
    import dataclasses
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.models import transformer as TF
    from repro_torch.serve import GenerationConfig, ServeEngine
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SB, SPROMPT)), device=dev).long()
    out = {}
    for backend, route in MESH_STATIC_ROUTES:
        model = get_model(dataclasses.replace(cfg, decode_backend=backend))
        eng = ServeEngine(model, params, max_len=SMAX, device=dev, mesh=mesh)
        eng.generate({"tokens": prompts}, GenerationConfig(max_new_tokens=2))
        logits = []
        real_p, real_d = TF.prefill_fn, TF.decode_fn

        def prefill(*a, **k):
            lg, st = real_p(*a, **k)
            logits.append(lg.clone())
            return lg, st

        def decode(*a, **k):
            lg, st = real_d(*a, **k)
            logits.append(lg.clone())
            return lg, st
        with mock.patch.object(TF, "prefill_fn", prefill), \
                mock.patch.object(TF, "decode_fn", decode):
            _sync_dev(torch, dev)
            reset_counts(counters)
            res = eng.generate({"tokens": prompts},
                               GenerationConfig(max_new_tokens=SNEW))
            _sync_dev(torch, dev)
            launches = read_counts(counters)
        digests = [_digest(torch, x) for x in logits]
        if keep is not None:
            logits = [x.cpu() for x in logits[:keep + 1]]
        out[route] = {"tokens": res["tokens"], "logits": logits,
                      "digests": digests, "launches": launches,
                      "bytes": res["cache_bytes"] - 4 * cfg.num_layers,
                      "head_shard": res["head_shard"],
                      "decode_s": res["decode_s"]}
    return out


def static_expect(launches: dict, cfg, route: str) -> tuple[dict, int]:
    """A polar ``ServeEngine`` run's exact launches at the static shape,
    and its encodes of the decode form: a prefill launch of #3 and #1 a
    layer, one flush a layer at position 1023 (the decode form), and the
    route's attention kernel once a layer and decode step."""
    nl = cfg.num_layers
    return ({**dict.fromkeys(launches, 0), "polar_encode": 2 * nl,
             "flash_prefill": nl, route: nl * (SNEW - 1)}, nl)


def _static_gate(torch, got: dict, want: dict, label: str) -> str:
    """Bit-equal logits over the prefill and every decode step (by digest);
    else, where every differing step was kept whole, the rel. L2 error
    over them (limit 1e-6). A difference at a step not kept whole fails:
    its error was not measured."""
    assert len(got["digests"]) == len(want["digests"]), label
    if got["digests"] == want["digests"]:
        return "bit-equal"
    n = len(got["logits"])
    differ = [i for i, (a, b) in enumerate(zip(got["digests"],
                                               want["digests"])) if a != b]
    assert differ[-1] < n, (f"{label}: logits differ at steps {differ[:8]}"
                            f"{'...' if len(differ) > 8 else ''}, past the "
                            f"{n} kept whole")
    return _logit_gate(torch, got["logits"], want["logits"][:n], label,
                       lambda: f"the digests differ at steps {differ[:8]}")


#: the serving launcher's arguments in :func:`cli_line`
CLI_ARGS = ("--engine", "cb", "--decode-backend", "paged_fused",
            "--prefill-backend", "paged_fused", "--batch", "4", "--gen", "16")


def cli_line(torch, dev="cuda") -> str:
    """``repro_torch.launch.serve.main`` in this process at tinyllama-1.1b's
    full width (``--engine cb``, both page-native backends, 4 requests, 16
    new tokens), once meshless and once with ``--mesh-shape 1x1``: each
    printed first sequence equals the engine called directly on the
    params the launcher draws."""
    import io
    import numpy as np
    from repro_torch.launch import serve as launch
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    t0 = time.monotonic()
    argv = list(CLI_ARGS) + ([] if dev == "cuda"
                             else ["--device", str(dev)])
    firsts = []
    for extra in ([], ["--mesh-shape", "1x1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert launch.main(argv + extra) == 0
        lines = buf.getvalue().splitlines()
        assert lines[-1].startswith("[serve] first sequence: "), lines
        firsts.append(json.loads(lines[-1].split(": ", 1)[1]))
    args = launch.parse_args(argv)
    cfg, model, params = launch.build(args)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    shared = rng.integers(0, cfg.vocab_size, (args.shared_prefix_len,))
    eng = ContinuousBatchingEngine(model, params, max_slots=args.batch,
                                   max_len=args.max_len, device=dev)
    out = eng.run([Request(rid=i, prompt=np.concatenate(
        [shared, toks[i]]).astype(np.int32), max_new_tokens=args.gen,
        arrival_time=0.0 if i == 0 else 100.0 + 0.01 * i)
        for i in range(args.batch)], GenerationConfig(
            max_new_tokens=args.gen, seed=args.seed))
    want = [r for r in out["requests"] if r.rid == 0][0].out_tokens
    assert firsts == [want, want], (firsts, want)
    del params, model, eng
    return (f"cli: python -m repro_torch.launch.serve {' '.join(argv)} "
            f"(tinyllama-1.1b, {cfg.num_layers} layers) and the same with "
            "--mesh-shape 1x1, in this process: each first sequence "
            f"({len(want)} tokens) equal to the engine called directly on "
            f"the launcher's params; {time.monotonic() - t0:.1f} s")


def _mesh_arms(cfg, smoke: bool) -> dict:
    """The engine options of each workload arm: ``classic``, and for a
    full-width config ``prefix`` (chunked prefill with the prefix cache)
    and ``spec`` (ngram, k :data:`MESH_SPEC_K`, on the config's decode
    backend's verifier; the classic workload)."""
    from repro_torch.spec import SpecConfig
    arms = {"classic": {}}
    if not smoke:
        arms["prefix"] = {"prefill_chunk": TC, "prefix_cache": True}
        arms["spec"] = {"spec": SpecConfig(mode="ngram", k=MESH_SPEC_K)}
    return arms


def _arm_work(work: dict, arm: str) -> list:
    """An arm's requests: the spec and run-ahead arms serve the classic
    workload."""
    return work.get(arm, work["classic"])


def _arm_flushes(cfg, got: dict, reqs: list) -> int:
    """The decode-form encodes among an arm's launches, asserting a spec
    arm's launches exactly (:func:`spec_expect`)."""
    if got["result"]["spec"] is None:
        return decode_flushes(cfg, got["decode_steps"])
    expect, flushes = spec_expect(got["launches"], cfg, got["result"],
                                  [len(p) for _, p, _, _ in reqs])
    assert got["launches"] == expect, (got["launches"], expect)
    return flushes


def _logit_gate(torch, got: list, want: list, label: str, probe) -> str:
    """Bit-equal decode logits, step for step; else the relative L2 error
    (limit 1e-6) with the op that first differs (``probe()``, for example
    :func:`_mesh_op_probe`), named also when the limit fails."""
    assert len(got) == len(want), (label, len(got), len(want))
    if all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want)):
        return "bit-equal"
    rel = max(float((a.cpu().float() - b.cpu().float()).norm()
                    / b.cpu().float().norm()) for a, b in zip(got, want))
    op = probe()
    assert rel <= 1e-6, (f"{label}: decode logits differ, rel L2 {rel:.3e}; "
                         f"first differing op: {op}")
    return f"rel L2 {rel:.3e} (limit 1e-6; first differing op: {op})"


def mesh_rank_main(argv: list[str]) -> int:
    """One rank of a spawned world: ``--mesh-rank R --mesh-world N
    --mesh-dir D --mesh-config NAME --mesh-depth K --mesh-smoke 0|1
    --mesh-dev DEV``. Joins the gloo world through ``D/rdzv``, serves the
    workload arms on ``EngineCore(mesh=(1, N))`` (and, for a full-width
    config, the static engine's routes on ``ServeEngine(mesh=)``:
    :func:`mesh_static`) and saves its results to ``D/rank_R.pt``. The kernels are built by the parent before any rank
    starts: a rank loads them and never runs nvcc."""
    import torch
    import torch.distributed as dist
    args = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(args["--mesh-rank"]), int(args["--mesh-world"])
    out_dir, dev = Path(args["--mesh-dir"]), args["--mesh-dev"]
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import (
        flash_prefill, paged_decode, paged_prefill, polar_attention,
        polar_encode, polar_qk,
    )
    from repro_torch.launch.mesh import init_world, make_mesh
    counters = (polar_encode, paged_decode, flash_prefill, paged_prefill,
                polar_attention, polar_qk)
    # the ranks share the host's cores with each other and the parent;
    # their host work is the schedule, the gloo staging and the launches
    torch.set_num_threads(1)
    init_world(rank, world, f"file://{out_dir / 'rdzv'}", "gloo",
               timeout_s=60)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        smoke = args["--mesh-smoke"] == "1"
        cfg, model, params = _mesh_model(
            torch, args["--mesh-config"], int(args["--mesh-depth"]), smoke,
            dev)
        work = _mesh_workload(cfg, smoke)
        res = {}
        for arm, kw in _mesh_arms(cfg, smoke).items():
            r = mesh_serve(torch, model, params, counters,
                           _arm_work(work, arm), dev, mesh=mesh, smoke=smoke,
                           **kw)
            r["logits"] = [x.cpu() for x in r["logits"]]
            res[arm] = r
        # the ranks' streams, events and logits, compared on every rank
        mine = {a: (r["streams"], r["events"]) for a, r in res.items()}
        if not smoke:
            res["static"] = mesh_static(torch, cfg, params, counters, dev,
                                        mesh=mesh, keep=MESH_KEEP_STEPS)
            mine["static"] = [r["tokens"].tolist()
                              for r in res["static"].values()]
        every = [None] * world
        dist.all_gather_object(every, mine)
        res["ranks_agree"] = all(x == every[0] for x in every)
        torch.save(res, out_dir / f"rank_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_world(name, depth, world, smoke, dev, out_dir: Path) -> list:
    """Start ``world`` rank processes of this script (their output to
    ``out_dir/rank_R.log``)."""
    procs = []
    for r in range(world):
        log = open(out_dir / f"rank_{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             str(r), "--mesh-world", str(world), "--mesh-dir", str(out_dir),
             "--mesh-config", name, "--mesh-depth", str(depth),
             "--mesh-smoke", str(int(smoke)), "--mesh-dev", str(dev)],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    return procs


def _join_world(torch, procs: list, out_dir: Path, deadline: float) -> list:
    """Wait for every rank (killing the rest once one fails or the
    deadline passes) and load their results; a failed rank fails the
    run, its log's tail in the error."""
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append((r, rc))
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    if failed:
        tails = "\n".join(
            f"rank {r} ({rc}):\n" + (out_dir / f"rank_{r}.log").read_text()[
                -3000:] for r, rc in failed)
        raise AssertionError(f"mesh ranks failed: {tails}")
    return [torch.load(out_dir / f"rank_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _mesh_op_probe(torch, dev) -> str:
    """Which op of a head shard's decode attention differs from the same
    heads of the whole call, at llama3.1-8b's shapes (8 slots, 8 kv heads
    x 4 query heads, d 128, 8 pages, bf16 values; the shard: 4 kv heads,
    planned for 8): #2's partials, the residual partials, the merge. The
    first op that is not bit-equal, or ``none``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    s, hkv, qh, d, n = 8, 8, 4, D128, 8
    p, pp = d // 2, s * n + 1
    codes, stats = _d128_stats(torch, dev, gen, pp, hkv, p)
    vals = torch.randn((pp, hkv, G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q4 = torch.randn((s, hkv, qh, d), generator=gen, device=dev) * d ** -0.5
    res = torch.randn((s, hkv, G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    table = torch.randperm(pp - 1, generator=gen, device=dev)[:s * n] \
        .reshape(s, n).to(torch.int32)
    lengths = torch.arange(s, device=dev, dtype=torch.int32) * 113 + 90
    flushed = (lengths // G) * G
    blk = slice(0, hkv // 2)

    def part(x):
        return x[:, blk].contiguous()

    whole = pd.polar_paged_decode_grouped(q4, codes, *stats, vals, table,
                                          flushed)
    shard = pd.polar_paged_decode_grouped(
        part(q4), part(codes), *(part(x) for x in stats), part(vals), table,
        flushed, plan_heads=hkv)
    ops_ = [("paged_decode partials (#2)", whole, shard)]
    v_res = vals[table[:, 0].long()].float()
    r_whole = ops._residual_flash_partials(q4, res, lengths - flushed, v_res)
    r_shard = ops._residual_flash_partials(part(q4), part(res),
                                           lengths - flushed, part(v_res))
    ops_.append(("residual partials (einsum, amax, exp, sum, einsum)",
                 r_whole, r_shard))
    ops_.append(("merge_softmax_partials",
                 ops.merge_softmax_partials([whole, r_whole]),
                 ops.merge_softmax_partials([shard, r_shard])))
    for name, a, b in ops_:
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all(torch.equal(x[:, blk], y) for x, y in zip(a, b)):
            return name
    return "none"


def _part1_arms(model) -> list:
    """Part 1's arms: (name, model, engine options). The classic and prefix
    arms, the scan verifier's spec arm (``model``'s ``"paged_fused"``
    route) and the span verifier's (the same weights on ``"jnp"``), and
    ``runahead=4`` (held to the classic arm's meshless run)."""
    import dataclasses
    from repro_torch.models import get_model
    kws = _mesh_arms(model.cfg, False)
    span = get_model(dataclasses.replace(model.cfg, decode_backend="jnp"))
    return [("classic", model, kws["classic"]),
            ("prefix", model, kws["prefix"]),
            ("spec[scan]", model, kws["spec"]),
            ("spec[span]", span, kws["spec"]),
            ("runahead", model, {"runahead": 4})]


def phase_mesh(torch, counters, model, params, dev="cuda",
               backend="nccl") -> dict:
    """Head-sharded serving (DESIGN.md §17), three parts and a line:

    1. a ``backend`` (NCCL) world of one in this process (file rendezvous
       in a temp directory): ``EngineCore(mesh=(1, 1))`` on ``model`` —
       the sharded dispatch, its head gather an all-reduce inside the
       replayed graphs — against the meshless engine, one-shot, chunked +
       prefix cache, ngram speculation (k :data:`MESH_SPEC_K`) on each
       verifier (graphed) and ``runahead=4`` (taken, left unused: held to
       the meshless ``runahead=0`` run): streams, events and every decode
       step's logits (a verify's argmaxes and accept counts) bit-equal,
       the same launches; then ``ServeEngine(mesh=)`` on
       both static routes (#5, #6; :func:`mesh_static`) against the
       meshless ``ServeEngine``: tokens, the prefill's and every decode
       step's logits bit-equal, the same launches and cache bytes;
    2. :data:`MESH_WORLDS`' llama3.1-8b over two gloo ranks spawned from
       here (their step eager, chosen before capture) in the classic,
       prefix and spec (scan verifier) arms: streams equal to the meshless
       engine's run here, decode logits bit-equal (else rel. L2 1e-6 with
       the first differing op named), each rank's pool bytes exactly
       half, per-rank launches equal to the meshless run's; and the
       static routes: tokens equal, logits bit-equal by digest, each
       rank's linear-cache bytes exactly half;
    3. the smoke tinyllama over four gloo ranks, spawned with part 2: the
       GQA fallback (2 KV heads; every rank holds the whole pools, no
       collective in the step, graphs replayed), streams equal;

    and :func:`cli_line`: the serving launcher in this process, meshless
    and on a ``1x1`` mesh.

    Returns the launches under the kernel rows' names: part 1's on the
    tinyllama rows, rank 0's of part 2 on the ``[d128,mesh2]`` rows."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_mesh
    t_phase = time.monotonic()
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        tmp = Path(tmp)
        started = []
        for i, (name, depth, world, smoke) in enumerate(MESH_WORLDS):
            d = tmp / f"world{i}"
            d.mkdir()
            started.append((name, depth, world, smoke, d,
                            _spawn_world(name, depth, world, smoke, dev, d)))
        deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
        try:
            # part 1, while the ranks come up
            t0 = time.monotonic()
            init_world(0, 1, f"file://{tmp / 'rdzv1'}", backend,
                       timeout_s=60)
            try:
                mesh = make_mesh((1, 1), ("data", "model"))
                assert mesh.backend("model") == backend
                work = _mesh_workload(model.cfg, False)
                bases = {}
                for arm, amodel, kw in _part1_arms(model):
                    reqs = _arm_work(work, arm)
                    if arm == "runahead":
                        base = bases["classic"]
                    else:
                        base = bases[arm] = mesh_serve(
                            torch, amodel, params, counters, reqs, dev, **kw)
                    got = mesh_serve(torch, amodel, params, counters, reqs,
                                     dev, mesh=mesh, **kw)
                    assert got["head_shard"] == (0, 1)
                    assert got["graphs"] == (dev == "cuda")
                    assert got["streams"] == base["streams"], arm
                    assert got["events"] == base["events"], arm
                    assert got["launches"] == base["launches"], \
                        (arm, got["launches"], base["launches"])
                    gate = _logit_gate(torch, got["logits"], base["logits"],
                                       f"mesh[{backend} x1,{arm}]",
                                       lambda: _mesh_op_probe(torch, dev))
                    assert gate == "bit-equal", gate
                    note = ""
                    if arm == "runahead":
                        ra = got["result"]["runahead"]
                        assert (ra["h"], ra["horizons"], ra["tokens"]) == \
                            (4, 0, 0), ra
                        note = ("; runahead=4 taken and left unused (h 4, "
                                "0 horizons), held to the meshless "
                                "runahead=0 run")
                    if got["result"]["spec"] is not None:
                        sp = got["result"]["spec"]
                        note = (f"; ngram k {MESH_SPEC_K}: {sp['steps']} "
                                f"verifies, {sp['accepted_tokens']} of "
                                f"{sp['drafted_tokens']} drafts accepted, "
                                f"verifies by span width "
                                f"{sp['dispatches_by_q']}")
                    add(encode_forms(got["launches"], _arm_flushes(
                        amodel.cfg, got, reqs)))
                    print(f"mesh[{backend} x1,{arm}]: {model.cfg.name} at "
                          f"full width ({model.cfg.num_layers} layers), "
                          f"{len(reqs)} requests at t = 0, "
                          f"{got['decode_steps']} decode steps "
                          + ("replayed with the head gather ("
                             f"{backend} all-reduce) inside the graphs"
                             if got["graphs"] else "eager")
                          + ": streams, events and every "
                          f"step's logits {gate} to the meshless engine's"
                          f"{note}; decode step mean {got['step_ms']:.3f} ms "
                          f"(meshless {base['step_ms']:.3f} ms); launches "
                          f"{json.dumps(got['launches'])}", flush=True)
                del bases
                t1 = time.monotonic()
                base = mesh_static(torch, model.cfg, params, counters, dev)
                got = mesh_static(torch, model.cfg, params, counters, dev,
                                  mesh=mesh)
                for route, g in got.items():
                    b = base[route]
                    expect, flushes = static_expect(g["launches"],
                                                    model.cfg, route)
                    assert g["launches"] == b["launches"] == expect, \
                        (route, g["launches"], b["launches"], expect)
                    assert g["head_shard"] == (0, 1)
                    assert (g["tokens"] == b["tokens"]).all(), route
                    assert g["bytes"] == b["bytes"], (g["bytes"], b["bytes"])
                    gate = _static_gate(torch, g, b,
                                        f"mesh[{backend} x1,static,{route}]")
                    assert gate == "bit-equal", gate
                    add(encode_forms(g["launches"], flushes))
                    print(f"mesh[{backend} x1,static,{route}]: ServeEngine("
                          f"mesh=), {SB} rows x {SPROMPT}-"
                          f"token prompts, {SNEW} new: tokens and the "
                          f"prefill's and all {SNEW - 1} decode steps' "
                          f"logits {gate} to the meshless ServeEngine's; "
                          f"cache {g['bytes']} B (meshless {b['bytes']}); "
                          f"decode {g['decode_s']:.3f} s (meshless "
                          f"{b['decode_s']:.3f} s); launches "
                          f"{json.dumps(g['launches'])}", flush=True)
                del base, got
                print(f"mesh: {backend} world of one static arm "
                      f"{time.monotonic() - t1:.1f} s", flush=True)
            finally:
                dist.destroy_process_group()
            print(f"mesh: {backend} world of one {time.monotonic() - t0:.1f}"
                  " s", file=sys.stderr, flush=True)
            print(f"mesh: {backend} world of one {time.monotonic() - t0:.1f}"
                  " s", flush=True)
            # parts 2 and 3: the meshless references here, then the ranks
            for name, depth, world, smoke, d, procs in started:
                t0 = time.monotonic()
                cfg, mmodel, mparams = _mesh_model(torch, name, depth, smoke,
                                                   dev)
                work = _mesh_workload(cfg, smoke)
                base = {arm: mesh_serve(torch, mmodel, mparams, counters,
                                        _arm_work(work, arm), dev,
                                        smoke=smoke, **kw)
                        for arm, kw in _mesh_arms(cfg, smoke).items()}
                static = None if smoke else mesh_static(
                    torch, cfg, mparams, counters, dev)
                del mparams, mmodel
                t_ref = time.monotonic() - t0
                ranks = _join_world(torch, procs, d, deadline)
                split = cfg.num_kv_heads % world == 0
                assert all(r["ranks_agree"] for r in ranks)
                for arm, b in base.items():
                    gates = []
                    for r, res in enumerate(ranks):
                        got = res[arm]
                        assert got["streams"] == b["streams"], (name, arm, r)
                        assert got["events"] == b["events"], (name, arm, r)
                        assert got["launches"] == b["launches"], \
                            (name, arm, r, got["launches"], b["launches"])
                        if split:
                            assert got["head_shard"] == (r, world)
                            assert got["graphs"] is False   # gloo: eager
                            assert got["pool_bytes"] * world == \
                                b["pool_bytes"], (got["pool_bytes"],
                                                  b["pool_bytes"])
                        else:
                            assert got["head_shard"] is None
                            assert got["graphs"] == (dev == "cuda")
                            assert got["pool_bytes"] == b["pool_bytes"]
                        gates.append(_logit_gate(
                            torch, got["logits"], b["logits"],
                            f"mesh[gloo x{world},{name},{arm}]",
                            lambda: _mesh_op_probe(torch, dev)))
                    r0 = ranks[0][arm]
                    _arm_flushes(cfg, r0, _arm_work(work, arm))
                    steps = ", ".join(f"{x[arm]['step_ms']:.3f}"
                                      for x in ranks)
                    print(f"mesh[gloo x{world},{name},{arm}]: "
                          f"{describe(cfg, cfg)}; "
                          + ("KV pools split over KV heads, "
                             f"{cfg.num_kv_heads // world} a rank, "
                             "decode eager (gloo)" if split else
                             f"{cfg.num_kv_heads} KV heads do not divide "
                             f"{world}: pools replicated on every rank (the "
                             "GQA fallback), no collective in the step, "
                             "decode " + ("graphs replayed" if r0["graphs"]
                                          else "eager"))
                          + f"; {len(_arm_work(work, arm))} requests, every "
                          f"rank's streams and events equal to the meshless "
                          f"engine's and to each other's; decode logits per "
                          f"rank: {', '.join(gates)}; pool bytes a "
                          f"rank {r0['pool_bytes']} (meshless "
                          f"{b['pool_bytes']}); decode step mean a rank "
                          f"{steps} ms "
                          f"(meshless {b['step_ms']:.3f} ms); launches a "
                          f"rank {json.dumps(r0['launches'])}", flush=True)
                    if split and not smoke:
                        form = f"[d128,mesh{world}]"
                        for k, n in r0["launches"].items():
                            if n:
                                row = k.split("[")[0] + form
                                total[row] = total.get(row, 0) + n
                for route, b in (static or {}).items():
                    gates = []
                    for r, res in enumerate(ranks):
                        g = res["static"][route]
                        gates.append(_static_gate(
                            torch, g, b,
                            f"mesh[gloo x{world},{name},static,{route}]"))
                        assert (g["tokens"] == b["tokens"]).all(), \
                            (name, route, r)
                        assert g["launches"] == b["launches"] == \
                            static_expect(b["launches"], cfg, route)[0], \
                            (name, route, r, g["launches"], b["launches"])
                        assert g["head_shard"] == ((r, world) if split
                                                   else None)
                        assert g["bytes"] * (world if split else 1) == \
                            b["bytes"], (g["bytes"], b["bytes"])
                    g0 = ranks[0]["static"][route]
                    print(f"mesh[gloo x{world},{name},static,{route}]: "
                          f"ServeEngine(mesh=), {SB} rows x "
                          f"{SPROMPT}-token prompts, {SNEW} new, linear "
                          f"caches split over KV heads, "
                          f"{cfg.num_kv_heads // world} a rank: every "
                          "rank's tokens equal to the meshless "
                          f"ServeEngine's; logits per rank over the prefill "
                          f"and {SNEW - 1} decode steps: {', '.join(gates)}; "
                          f"cache bytes a rank {g0['bytes']} (meshless "
                          f"{b['bytes']}); decode a rank "
                          + ", ".join(f"{x['static'][route]['decode_s']:.3f}"
                                      for x in ranks)
                          + f" s (meshless {b['decode_s']:.3f} s); launches "
                          f"a rank {json.dumps(g0['launches'])}", flush=True)
                    for k, n in g0["launches"].items():
                        if n:
                            row = k.split("[")[0] + f"[d128,mesh{world}]"
                            total[row] = total.get(row, 0) + n
                del static
                print(f"mesh: gloo x{world} {name} done "
                      f"{time.monotonic() - t_phase:.1f} s into the phase "
                      f"(its meshless runs here {t_ref:.1f} s; its ranks "
                      "started with the phase)", file=sys.stderr, flush=True)
        finally:
            for *_, procs in started:
                for p, log in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    log.close()
    print(cli_line(torch, dev), flush=True)
    print(f"mesh: {time.monotonic() - t_phase:.1f} s; launches "
          f"{json.dumps(total)}", flush=True)
    print(f"mesh: {time.monotonic() - t_phase:.1f} s", file=sys.stderr,
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 11: QoS and chaos (DESIGN.md §16) on graphed decode
# ---------------------------------------------------------------------------


def alloc_invariants(alloc) -> None:
    """No leak, no double free: every page is free exactly once or
    referenced, and slot mappings plus external pins account for every
    reference (``tests/test_prefix_cache.py::check_alloc_invariants``)."""
    free = list(alloc._free)
    assert len(free) == len(set(free)), "page duplicated in the free list"
    refs = [0] * alloc.layout.num_pages
    for s in range(alloc.layout.slots):
        for pg in alloc.slot_page_ids(s):
            refs[pg] += 1
    for pg, n in enumerate(refs):
        assert (pg in free) == (alloc.refcount(pg) == 0), pg
        assert alloc.refcount(pg) >= n, pg
    assert len(free) + int((alloc._ref > 0).sum()) == alloc.layout.num_pages


def phase_qos(torch, model, params, counters) -> dict:
    """QoS and fault injection at full width (tinyllama), decode steps
    replayed as graphs; 24 greedy requests (prompts 100-900, 32 new), all
    at t = 0.

    QoS run: three tenants (weights 1 / 1 / 2; tenant ``b`` starts with
    an empty token bucket and lives on its refill), ``max_pending`` 16,
    degradation on, a 1 s TTFT deadline, ``runahead=4``: every request
    ends in exactly one terminal event, the pool drains back whole, no
    horizon runs under QoS, exact launches; ``result()["qos"]`` and the
    goodput under the deadline are printed.

    Chaos runs (ngram speculation, k 4): an injector with an empty
    schedule gives ``chaos=None``'s streams and events; the schedule
    ``exhaust@8,slow@5:0.05,cancel@12:0.5,proposer@0.3`` leaves its
    survivors the streams of the plain graphed engine, releases its
    quarantine, keeps the allocator's invariants and lets no proposer
    fault escape (every fault counted is an injected one). Returns the
    launches of every run, summed."""
    import numpy as np
    from repro_torch.serve import (
        ChaosConfig, ChaosInjector, ContinuousBatchingEngine,
        GenerationConfig, QosConfig, Request, check_event_stream,
        goodput_under_sla,
    )
    from repro_torch.spec import SpecConfig
    t_phase = time.monotonic()
    cfg = model.cfg
    rng = np.random.default_rng(51)
    n_req, new = 24, 32
    lens = [int(t) for t in rng.integers(100, 901, n_req)]
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
               for t in lens]
    tenants = ["a", "b", "c"] * (n_req // 3)
    total: dict = {}

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=new,
                        tenant=tenants[i]) for i, p in enumerate(prompts)]

    def drive(eng, chaos="keep", tweak=None):
        """Serve ``reqs()`` on ``eng`` (its chaos swapped unless
        ``"keep"``), counters set to 0 just before and read just after;
        returns (result with events, the requests, launches)."""
        patch = (mock.patch.object(eng.core, "chaos", chaos)
                 if chaos != "keep" else contextlib.nullcontext())
        with patch:
            core = eng.core
            core.reset(GenerationConfig())
            if tweak is not None:
                tweak(core)
            rs = reqs()
            for r in rs:
                core.add_request(r)
            torch.cuda.synchronize()
            reset_counts(counters)
            events = list(core.events())
            torch.cuda.synchronize()
            launches = read_counts(counters)
            out = core.result()
        out["events"] = events
        alloc = core.sched.alloc
        alloc_invariants(alloc)
        assert alloc.quarantined_pages == 0, "quarantine never released"
        assert alloc.free_pages == core.layout.num_pages, "pages leaked"
        assert not any(e.kind == "preempt" for e in events)
        return out, rs, launches

    def admitted(rs):
        return [len(r.prompt) for r in rs if r.t_admitted is not None]

    def add(launches, flushes):
        for k, n in encode_forms(launches, flushes).items():
            total[k] = total.get(k, 0) + n

    # --- QoS -----------------------------------------------------------
    qos = QosConfig(max_pending=16, degrade=True, ttft_slo=1.0,
                    tenant_budget=2000.0, tenant_burst=1e6,
                    weights={"a": 1.0, "b": 1.0, "c": 2.0})
    eng = ContinuousBatchingEngine(model, params, max_slots=8, max_len=1024,
                                   runahead=4, qos=qos)
    eng.warmup(lens)

    def broke(core):
        core.qos.tenant("b").bucket = 0.0
    out, rs, launches = drive(eng, tweak=broke)
    terminal = check_event_stream(out["events"])
    assert sorted(terminal) == list(range(n_req)), sorted(terminal)
    kinds = {k: sum(v == k for v in terminal.values())
             for k in ("finish", "shed", "reject")}
    assert sum(kinds.values()) == n_req, terminal
    assert kinds["reject"] == n_req - qos.max_pending, kinds
    assert out["runahead"]["horizons"] == 0, "a horizon ran under QoS"
    done = out["requests"]
    assert all(r.done_tokens == new for r in done)
    expect = serve_expect(launches, cfg, out, admitted(rs))
    assert launches == expect, (launches, expect)
    add(launches, decode_flushes(cfg, out["decode_steps"]))
    q = out["qos"]
    good = goodput_under_sla(rs, out["wall_s"], qos.ttft_slo)
    admits = [e.rid for e in out["events"] if e.kind == "admit"]
    print(f"qos: {n_req} requests x {new} tokens from tenants a / b / c "
          f"(weights 1 / 1 / 2, b's bucket empty at 2000 tokens/s), "
          f"max_pending {qos.max_pending}, TTFT deadline {qos.ttft_slo} s, "
          f"runahead 4 (no horizon ran): {serve_line(out)}; terminal "
          f"{json.dumps(kinds)}; admission order {admits}; shed "
          f"{q['shed']}, rejected {q['rejected']}, degrade "
          f"{json.dumps(q['degrade'])}, prefill rate "
          f"{q['prefill_rate_est'] or 0:.0f} tok/s; tenants " + json.dumps(
              {t: {k: v[k] for k in ("admitted", "shed", "rejected",
                                     "served_tokens")}
               for t, v in q["tenants"].items()})
          + f"; goodput under SLA {good['goodput_tokens_per_s']:.1f} tok/s, "
          f"deadline met {good['deadline_met_requests']} / missed "
          f"{good['deadline_missed_requests']}; launches "
          f"{json.dumps(launches)}", flush=True)

    # --- chaos ---------------------------------------------------------
    plain = ContinuousBatchingEngine(model, params, max_slots=8,
                                     max_len=1024)
    plain.warmup(lens)
    out, rs, launches = drive(plain)
    add(launches, decode_flushes(cfg, out["decode_steps"]))
    base = {r.rid: list(r.out_tokens) for r in out["requests"]}
    spec = ContinuousBatchingEngine(model, params, max_slots=8, max_len=1024,
                                    spec=SpecConfig(mode="ngram", k=4))
    spec.warmup(lens)
    outs = {}
    spec_chaos = ChaosConfig.parse(
        "exhaust@8,slow@5:0.05,cancel@12:0.5,proposer@0.3", seed=3)
    for arm, inj in (("none", None), ("empty", ChaosInjector(ChaosConfig())),
                     ("chaos", ChaosInjector(spec_chaos))):
        out, rs, launches = drive(spec, chaos=inj)
        check_event_stream(out["events"])
        expect, flushes = spec_expect(launches, cfg, out, admitted(rs))
        assert launches == expect, (arm, launches, expect)
        add(launches, flushes)
        outs[arm] = out
        for r in out["requests"]:
            assert r.out_tokens == base[r.rid], \
                f"chaos[{arm}]: survivor rid {r.rid} left the plain stream"
    def key(o):
        return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span,
                 e.span_ix) for e in o["events"]]
    assert key(outs["empty"]) == key(outs["none"]), \
        "an empty chaos schedule changed the events"
    assert outs["empty"]["chaos"]["proposer_calls"] == 0
    c = outs["chaos"]
    st = c["chaos"]
    assert (st["exhausts"], st["slow_steps"], st["cancel_storms"]) == \
        (1, 1, 1), st
    assert c["n_cancelled"] == st["storm_cancels"] > 0
    assert len(c["requests"]) + c["n_cancelled"] == n_req
    assert c["proposer_faults"] == st["proposer_faults"] > 0, \
        "a proposer fault that was not injected"
    print(f"chaos: ngram k 4, {n_req} requests x {new} tokens; empty "
          f"schedule == chaos=None (events); "
          f"exhaust@8,slow@5:0.05,cancel@12:0.5,proposer@0.3: "
          f"{serve_line(c)}; survivors {len(c['requests'])} equal the plain "
          f"graphed engine's streams, cancelled {c['n_cancelled']}; chaos "
          f"{json.dumps(st)}; spec steps {c['spec']['steps']}, acceptance "
          f"{c['spec']['acceptance_rate']:.3f}; quarantine released, "
          f"allocator invariants hold; phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    return total


def phase_profile(torch, model, params) -> None:
    """Where a full-batch decode step's time goes: wall time of 8-slot
    decode steps at 512 tokens (host clock around steps that end in the
    token fetch) against the device time of the kernels they launch
    (torch.profiler), issued eagerly and as a replayed graph of the same
    step (``serve/graphs.py``); then H = 8 run-ahead horizon replays,
    wall per micro-step against device busy per micro-step; the largest
    kernels of the eager step; and two chained horizons, timing the
    second's dispatch and the first block's landing with the engine's
    pinned inputs and per-block event against pageable inputs and a
    blocking ``.cpu()``. Runs after the serving phases; its
    launches are not part of the main path's counts."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.serve.graphs import DecodeGraphs
    dev = torch.device("cuda")
    s, t0, n, h = 8, 512, 5, 8
    layout = PagedLayout(page_size=G, num_pages=s * 8, slots=s,
                         pages_per_slot=8)
    state = model.init_paged_state(layout, dev)
    table = torch.arange(s * 8, dtype=torch.int32, device=dev).reshape(s, 8)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2)
    toks = torch.randint(0, model.cfg.vocab_size, (s, t0 + 8 * n),
                         generator=gen).to(dev)
    for sl in range(s):
        model.prefill_paged(params, toks[sl:sl + 1, :t0], state, sl,
                            table[sl], t0)
    active = torch.ones((s,), dtype=torch.bool, device=dev)
    graphs = DecodeGraphs(model, params, state,
                          torch.Generator(device=dev))
    host_table, mask = table.cpu(), np.ones(s, bool)
    budget, fresh = np.full(s, 10 ** 6, np.int32), np.zeros(s, bool)

    def eager(i):
        lg, _ = model.decode_paged(params, state, toks[:, t0 + i], table,
                                   active)
        return lg.argmax(-1).cpu()

    def replay(i):
        _, nxt = graphs.step(8, 0.0, 0, toks[:, t0 + i], host_table, mask)
        return nxt.cpu()

    def horizon(i):
        block = graphs.horizon(8, h, 0.0, 0, -1, toks[:, t0 + i],
                               host_table, mask, budget, fresh)[0]
        return block.cpu()

    def measure(fn, first):
        """(wall ms, device busy ms, top kernels) per call of ``fn``."""
        fn(first)
        torch.cuda.synchronize()
        w0 = time.monotonic()
        for i in range(first + 1, first + n + 1):
            fn(i)
        wall = (time.monotonic() - w0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(first + n + 1, first + 2 * n + 1):
                fn(i)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kern) / 1e3 / n
        count = sum(e.count for e in kern) / n
        return (wall, busy, count,
                sorted(kern, key=lambda e: -e.device_time_total))

    def share(wall, busy, count):
        return (f"device busy {busy:.3f} ms in {count:.0f} kernels (idle "
                f"{1 - busy / wall:.1%})" if busy > 0.0 else
                "device time not measured (the profiler saw no kernels)")

    def pageable(cap, values):
        """A replay whose host inputs are copied from pageable memory."""
        for name, x in values.items():
            x = torch.as_tensor(x)
            cap.inputs[name].copy_(x, non_blocking=True)
        cap.graph.replay()

    def chained(i, pinned, event):
        """Horizon A, then B chained off A's device carries, then A's
        block landed: (ms the host spent dispatching B, ms from A's
        dispatch until A's block is on the host, ms until both ran)."""
        cap = graphs.capture(8, h, 0.0, 0, -1)
        run = graphs._replay if pinned else pageable
        torch.cuda.synchronize()
        w0 = time.monotonic()
        run(cap, {"token": toks[:, t0 + i], "table": host_table,
                  "active": mask, "remaining": budget, "done": fresh})
        out = cap.outputs
        if event:
            block = torch.empty(out[0].shape, dtype=out[0].dtype,
                                pin_memory=True)
            block.copy_(out[0], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            block = out[0].clone()
        w1 = time.monotonic()
        run(cap, {"token": out[1], "table": host_table, "active": mask,
                  "remaining": out[3], "done": out[2]})
        w2 = time.monotonic()
        if event:
            ready.synchronize()
        else:
            block = block.cpu()
        w3 = time.monotonic()
        torch.cuda.synchronize()
        w4 = time.monotonic()
        return (w2 - w1) * 1e3, (w3 - w0) * 1e3, (w4 - w0) * 1e3

    e_wall, e_busy, e_n, top = measure(eager, 0)
    g_wall, g_busy, g_n, _ = measure(replay, 0)
    h_wall, h_busy, h_n, _ = measure(horizon, 0)
    # landing a block with a successor chained behind it: the engine's
    # route (pinned inputs, the block's own event) against pageable
    # inputs and a blocking .cpu() of the block, alternated
    arms = {"pinned+event": (True, True), "pageable+cpu": (False, False),
            "pinned+cpu": (True, False), "pageable+event": (False, True)}
    lands: dict = {k: [] for k in arms}
    first = 2 * n + 2
    for rep in range(4):
        for k, (pinned, event) in arms.items():
            lands[k].append(chained(first, pinned, event))
            first += 1
    lands = {k: np.median(np.array(v[1:]), axis=0) for k, v in lands.items()}
    tops = ", ".join(f"{e.key[:40]} {e.device_time_total / 1e3 / n:.3f} ms"
                     for e in top[:6])
    print(f"profile: 8-slot decode step at {t0} tokens: eager wall "
          f"{e_wall:.2f} ms, {share(e_wall, e_busy, e_n)}; graph replay "
          f"wall {g_wall:.2f} ms, {share(g_wall, g_busy, g_n)}; H={h} "
          f"horizon replay per micro-step (a token for each of the {s} "
          f"slots) wall {h_wall / h:.3f} ms, "
          f"{share(h_wall / h, h_busy / h, h_n / h)}; eager per step: "
          f"{tops}",
          flush=True)
    print(f"profile: two chained H={h} horizons, median of 3 (host ms "
          "dispatching the second / until the first block is on the host "
          "/ until both ran): " + "; ".join(
              f"{k} {d:.3f} / {land:.2f} / {tot:.2f}"
              for k, (d, land, tot) in lands.items()), flush=True)


def cut_depth(cfg, params, depth: int):
    """tinyllama-1.1b at its full width with only its first ``depth``
    layers, for the paths after ``graphs``: (config, model, params)."""
    import dataclasses
    from repro_torch.models import get_model
    cut = dataclasses.replace(cfg, num_layers=depth)
    print(f"runahead to profile: {cfg.name} at its full width, depth cut "
          f"from {cfg.num_layers} to {depth} layers", flush=True)
    return cut, get_model(cut), {**params, "layers": params["layers"][:depth]}


class PhaseClock:
    """Times each phase of ``main``. Besides keeping the seconds, it writes
    each phase's end to stderr as it happens, and every thread's stack if
    a phase runs past 240 s (none takes 100 s), so a run stopped at its
    time limit still shows how far it got, where the time went and where
    it hung."""

    def __init__(self, t_start: float):
        self.t_start, self.seconds = t_start, {}

    def run(self, name, fn, *args):
        import faulthandler
        t0 = time.monotonic()
        faulthandler.dump_traceback_later(240.0, exit=False)
        try:
            out = fn(*args)
        finally:
            faulthandler.cancel_dump_traceback_later()
        now = time.monotonic()
        self.seconds[name] = round(now - t0, 1)
        print(f"chip_smoke: {name} done in {now - t0:.1f} s, "
              f"{now - self.t_start:.1f} s since start", file=sys.stderr,
              flush=True)
        return out


def main() -> int:
    t_start = time.monotonic()
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(sys.argv[1:])
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
    from repro_torch.kernels import paged_prefill as ppk
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_encode as pe
    from repro_torch.kernels import polar_qk as qkk
    from repro_torch.models import get_model

    phase_env(torch)
    if sys.argv[1:2] == ["--variants"]:
        assert len(sys.argv) == 2, "usage: chip_smoke.py --variants"
        phase_variants(torch)
        return 0
    clock = PhaseClock(t_start)
    clock.run("build", phase_build)
    rows = clock.run("kernels", phase_kernels, torch)

    cfg = get_config("tinyllama-1.1b")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(generator=gen, device="cuda")
    clock.run("model", phase_model, torch, model, params)
    counters = (pe, pd, fpk, ppk, pak, qkk)
    serve, _ = clock.run("serve", phase_serve, torch, model, params, counters)
    clock.run("graphs", phase_graphs, torch, model, params)
    cfg, model, params = cut_depth(cfg, params, LATER_DEPTH)
    runahead = clock.run("runahead", phase_runahead, torch, model, params,
                         counters)
    spec = clock.run("spec", phase_spec, torch, model, params, counters)
    prefix = clock.run("prefix", phase_prefix, torch, model, params, counters)
    static = clock.run("static", phase_static, torch, cfg, params, counters)
    values = clock.run("values", phase_values, torch, cfg, params, counters)
    codecs = clock.run("codecs", phase_codecs, torch, cfg, params, counters)
    qos = clock.run("qos", phase_qos, torch, model, params, counters)
    clock.run("profile", phase_profile, torch, model, params)
    mesh = clock.run("mesh", phase_mesh, torch, counters, model, params)
    del params, model
    configs = clock.run("configs", phase_configs, torch, counters,
                        D128_CONFIGS, "configs")
    moe = clock.run("moe", phase_configs, torch, counters, MOE_CONFIGS, "moe")
    families = clock.run("families", phase_families, torch, counters)
    train, train_row = clock.run("train", phase_train, torch, counters)
    rows.append(train_row)

    phases = {"serve": serve, "runahead": runahead, "spec": spec,
              "prefix": prefix, "static": static, "values": values,
              "codecs": codecs, "qos": qos, "mesh": mesh, "configs": configs,
              "moe": moe, "families": families, "train": train}
    print("launches per serving phase: " + json.dumps(phases), flush=True)
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) for p in phases.values())
        assert r["launches"] > 0, f"{r['name']} never ran on the main path"
    print("seconds per phase: " + json.dumps(clock.seconds), flush=True)
    print(f"total: {time.monotonic() - t_start:.1f} s, kernel builds "
          "included", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
