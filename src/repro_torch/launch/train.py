"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

``--smoke`` trains the reduced config of the chosen architecture;
without it the full published config. It runs on the card unless
``--device`` names another device.

``--mesh host`` runs JAX's fully sharded step on ``make_host_mesh(
model_axis=1)``: a (world, 1) mesh, FSDP over every rank. Under
``python -m torch.distributed.run`` each process reads ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` and joins the world
(NCCL when every local rank has a card of its own, gloo otherwise, or
with ``--device``); without them it is a world of one. Only rank 0
prints::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --mesh host --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, list_configs, reduce_for_smoke
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import (init_world, launcher_world,
                                     make_host_mesh, rank_device)
from repro_torch.models import get_model
from repro_torch.train import StepConfig, Trainer, TrainerConfig
from repro_torch.utils import resolve_device

def _join(device):
    """(this rank's device, the world's backend or None, rank) for
    ``--mesh host``: the launcher's world when its variables are set,
    else a world of one."""
    world = launcher_world(os.environ)
    if world is None:
        return resolve_device(device), None, 0
    dev, backend = rank_device(device, world)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    init_world(world["rank"], world["size"], "env://", backend,
               timeout_s=120)
    return dev, backend, world["rank"]


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

    mesh, backend, rank, device = None, None, 0, args.device
    if args.mesh == "host":
        device, backend, rank = _join(args.device)
        mesh = make_host_mesh(model_axis=1)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = reduce_for_smoke(cfg)
        model = get_model(cfg)
        say(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
        if mesh is not None:
            say(f"[train] mesh {dict(mesh.shape)} over "
                f"{backend or 'no world'} (one process a position)")
        ds = SyntheticLMDataset(cfg, global_batch=args.batch,
                                seq_len=args.seq, seed=args.seed, mesh=mesh)
        trainer = Trainer(
            model, ds,
            TrainerConfig(total_steps=args.steps,
                          checkpoint_every=max(args.steps // 2, 1),
                          checkpoint_dir=args.ckpt, log_every=10,
                          seed=args.seed),
            StepConfig(peak_lr=args.lr, warmup_steps=min(30, args.steps // 3),
                       total_steps=args.steps,
                       microbatches=args.microbatches),
            mesh=mesh, device=device)
        res = trainer.run()
        say(f"[train] done: final loss {res['losses'][-1]:.7f} "
            f"(start {res['losses'][0]:.4f})")
    finally:
        if backend is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
