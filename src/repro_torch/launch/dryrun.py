"""The dry run's CLI (port of ``repro/launch/dryrun.py``): one rank's step
of every (arch x shape) on the production mesh, on no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --arch tinyllama-1.1b --shape train_4k

Each cell runs as rank 0 of a fake ``torch.distributed`` world of 256
(``single``: data 16 x model 16) or 512 (``multi``: pod 2 x data 16 x
model 16) ranks, on ``meta`` tensors, under the per-op cost model
(``launch/dryrun_lib.py``). It needs no card and touches none. One JSON
record a cell goes to ``--out`` (default ``artifacts/dryrun_torch``, apart
from JAX's ``artifacts/dryrun``). Skipped (JAX's rule) and refused (not
placeable by the port yet) cells are printed by name; the exit code is 1
only when a cell fails.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun_lib as lib
from repro_torch.train.train_step import StepConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run: one rank's step of every (arch x shape) on the "
                    "production mesh, counted on meta tensors.")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"],
                    help="16x16 single-pod or 2x16x16 multi-pod")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="block")
    args = ap.parse_args(argv)

    mesh_tag = "multi_2x16x16" if args.mesh == "multi" else "single_16x16"
    step_cfg = StepConfig(microbatches=args.microbatches, remat=args.remat)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]

    failures, refused, skipped, ok = [], [], [], 0
    for arch in archs:
        for shape in shapes:
            t0 = time.monotonic()
            try:
                rec = lib.run_cell(arch, shape, args.mesh, args.out,
                                   mesh_tag, step_cfg)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, repr(e)[:300]))
                print(f"[dryrun] {arch} x {shape}: FAIL {repr(e)[:200]}",
                      flush=True)
                continue
            if rec["status"] == "skip":
                skipped.append((arch, shape))
                print(f"[dryrun] {arch} x {shape}: SKIP "
                      f"({rec['reason'][:60]})", flush=True)
                continue
            if rec["status"] == "refused":
                refused.append((arch, shape))
                print(f"[dryrun] {arch} x {shape}: REFUSED "
                      f"({rec['reason'][:90]})", flush=True)
                continue
            ok += 1
            mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
            coll = rec["collectives"].get("total_bytes", 0)
            print(f"[dryrun] {arch} x {shape} [{mesh_tag}]: OK "
                  f"lower={rec['lower_s']:.1f}s "
                  f"peak/dev={mem['peak_per_device'] / 2**30:.2f}GiB "
                  f"fits80G={mem['fits_80g_hbm']} "
                  f"flops={cost['flops']:.3g} "
                  f"dot={rec['dot_flops']:.3g} "
                  f"bytes={cost['bytes accessed']:.3g} "
                  f"coll={coll:.3g}B "
                  f"args={mem['argument_bytes']:.3g}B "
                  f"jax_args={rec['jax_argument_bytes']:.3g}B "
                  f"roofline c/m/n={roof['compute_s']:.3g}/"
                  f"{roof['memory_s']:.3g}/{roof['collective_s']:.3g}s "
                  f"({rec['placement']}; "
                  f"{time.monotonic() - t0:.0f}s)", flush=True)

    print(f"[dryrun] {ok} ok, {len(skipped)} skipped, {len(refused)} "
          f"refused, {len(failures)} failed")
    if refused:
        print("[dryrun] refused: " + ", ".join(f"{a} x {s}"
                                               for a, s in refused))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
