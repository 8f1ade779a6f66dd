"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

``--smoke`` trains the reduced config of the chosen architecture;
without it the full published config. It runs on the card unless
``--device`` names another device. ``--mesh host`` (JAX's fully sharded
step) is refused until sharded training is ported.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, list_configs, reduce_for_smoke
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import get_model
from repro_torch.train import StepConfig, Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_launch_train"))
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mesh == "host":
        ap.error("--mesh host: sharded training is not ported yet "
                 "(ROADMAP.md queue 1, 'sharded training')")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    model = get_model(cfg)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    ds = SyntheticLMDataset(cfg, global_batch=args.batch, seq_len=args.seq,
                            seed=args.seed)
    trainer = Trainer(
        model, ds,
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=max(args.steps // 2, 1),
                      checkpoint_dir=args.ckpt, log_every=10,
                      seed=args.seed),
        StepConfig(peak_lr=args.lr, warmup_steps=min(30, args.steps // 3),
                   total_steps=args.steps, microbatches=args.microbatches),
        device=args.device)
    res = trainer.run()
    print(f"[train] done: final loss {res['losses'][-1]:.4f} "
          f"(start {res['losses'][0]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
