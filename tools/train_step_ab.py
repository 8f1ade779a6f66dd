#!/usr/bin/env python3
"""Time the port's eager training step and one kernel wrapper's host cost
from several checkouts in one call, on one card.

    python3 tools/train_step_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (an unpacked
``git archive`` of another commit, for instance); each runs in a process
of its own, with that checkout's package and CUDA sources, in the order
given, and prints one JSON line:

* ``step_ms``: the median of steps 2-20 of tinyllama-1.1b at full width
  through the meshless ``make_train_step`` (8 x 512 tokens, block remat,
  ce_chunk 512: the shape of ``chip_smoke.py``'s ``train`` phase; CUDA
  events), on the synthetic stream from seed 0;
* ``wrapper_us``: host microseconds per call of ``flash_prefill`` (#3)
  on a 1 x 1 x 64 x 64 bf16 causal input, the median of 5 rounds of 2000
  calls, each round ended by a synchronise: the wrapper's own cost plus
  one launch.

Needs one CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

STEPS = 20
CALLS, ROUNDS = 2000, 5


def run_one(root: str) -> dict:
    sys.path.insert(0, f"{root}/src")
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import flash_prefill as fpk
    from repro_torch.models import get_model
    from repro_torch.train import StepConfig, init_train_state, \
        make_train_step

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn((1, 1, 64, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    fpk.flash_prefill(q, q, q)              # builds and loads the kernel
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fpk.flash_prefill(q, q, q)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / CALLS * 1e6)

    cfg = get_config("tinyllama-1.1b")
    ds = SyntheticLMDataset(cfg, global_batch=8, seq_len=512, seed=0)
    batches = [ds.next_batch() for _ in range(STEPS)]
    model = get_model(cfg)
    step = make_train_step(model, None, StepConfig(
        peak_lr=3e-4, warmup_steps=5, total_steps=STEPS, remat="block",
        ce_chunk=512))
    state = init_train_state(model, 0, device="cuda")
    events = []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, _ = step(state, b)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events[1:])
    return {"root": root, "step_ms": ms[len(ms) // 2],
            "wrapper_us": sorted(rounds)[ROUNDS // 2],
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
