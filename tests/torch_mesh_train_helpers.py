"""Shared pieces of the sharded-training checks across processes
(``tests/test_torch_mesh_train*.py``): the gloo worlds' jobs (run by
``tests/torch_mesh_worker.py``, kind ``"train"``), JAX's meshless
references computed while they run, and the tolerance checks.

Every case runs three steps from the same numpy params (the port's seeded
init in JAX's layout) on the same numpy global batches (4 rows of
``T_TEXT`` tokens) with ``clip_norm`` 0.1, below every step's gradient
norm, so clipping bites. Tolerances are the training port's: loss
1e-5 * max(1, |loss|), metrics 1e-4 relative, gradients rtol 1e-4 and
atol 1e-4 * max|g| + 1e-7, the sharded AdamW against the meshless update
on the same gathered state and gradients 1e-6; the params after three
steps 1e-6 on all but a stated share of the elements, the others within
what the gradient tolerance lets AdamW move them (:func:`check_params`).
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_train_helpers as H
from repro.models import get_model as j_get_model
from repro.train import train_step as jts
from repro_torch.weights import init_params, params_to_jax
from test_torch_mesh_serve import GROUP_TIMEOUT_S, ROOT, _collect, _spawn

GB, STEPS = 4, 3
STEP_CFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                weight_decay=0.1, clip_norm=0.1, remat="block", ce_chunk=16)


def params_np(name: str) -> dict:
    """The port's seeded smoke init (fp32) in JAX's layout, numpy."""
    _, cfg = H.configs(name)
    gen = torch.Generator().manual_seed(0)
    return params_to_jax(init_params(cfg, generator=gen, device="cpu",
                                     dtype=torch.float32), cfg)


def batches_np(name: str) -> list:
    return [H.batch_np(H.configs(name)[1], batch=GB, seed=1, step=i)
            for i in range(STEPS)]


def jax_refs(params: dict, batches: dict) -> dict:
    """JAX's meshless ``make_train_step`` three steps from ``params`` on
    ``batches`` (remat "none" and the single-shot head: the same math,
    a smaller compile): per step its metrics and the gradients it
    applied; the state after. One jit a config."""
    refs = {}
    for name in params:
        jcfg, _ = H.configs(name)
        jm = j_get_model(jcfg)
        sc = jts.StepConfig(**dict(STEP_CFG, remat="none", ce_chunk=0))
        step = jts.make_train_step(jm, None, sc, jit=False)

        def run(state, batch, jm=jm, step=step):
            _, _, g = jts._loss_and_grad(jm, state.params, batch, "none", 0)
            new, met = step(state, batch)
            return new, met, g
        run = jax.jit(run)
        state = jts.TrainState(params=params[name],
                               opt=jts.adamw_init(params[name]))
        mets, grads = [], []
        for b in batches[name]:
            state, met, g = run(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            mets.append({k: float(v) for k, v in met.items()})
            grads.append(H.to_np(g))
        refs[name] = {"metrics": mets, "grads": grads,
                      "state": H.to_np(state)}
    return refs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_train(args: list, ckpt, dist_run: bool) -> subprocess.Popen:
    """``python -m repro_torch.launch.train ARGS --device cpu`` (under
    ``torch.distributed.run --nproc-per-node 2`` with ``dist_run``),
    stdout and stderr piped together."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    head = [sys.executable, "-m"]
    if dist_run:
        head += ["torch.distributed.run", "--nproc-per-node", "2",
                 "--master-addr", "127.0.0.1", "--master-port",
                 str(free_port()), "-m"]
    return subprocess.Popen(
        head + ["repro_torch.launch.train"] + args
        + ["--device", "cpu", "--ckpt", str(ckpt)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_worlds(tmp_path_factory, worlds: dict, names, extra=None) -> dict:
    """Spawn one gloo world per entry of ``worlds`` (world -> (cases,
    meshes)), each rank running the cases (config, mesh shape,
    microbatches) of its world; ``extra`` (world -> job entries) adds the
    checkpoint and trainer checks. JAX's references for ``names`` run
    here meanwhile. Returns {"worlds": {world: [rank results]}, "jax":
    the references, "params", "batches"}."""
    params = {n: params_np(n) for n in names}
    batches = {n: batches_np(n) for n in names}
    base = {"kind": "train", "timeout_s": GROUP_TIMEOUT_S,
            "params": params, "batches": batches, "global_batch": GB,
            "step_cfg": STEP_CFG, "meshless": True,
            "cfg_overrides": {"recurrentgemma-9b":
                              {"window": H.HYBRID_WINDOW}}}
    started = {}
    for world, (cases, meshes) in worlds.items():
        wd = tmp_path_factory.mktemp(f"train{world}")
        job = dict(base, cases=cases, meshes=meshes,
                   init_method=f"file://{wd / 'rdzv'}",
                   **(extra or {}).get(world, {}))
        path = wd / "job.pkl"
        with open(path, "wb") as f:
            pickle.dump(job, f)
        started[world] = (path, _spawn(path, world))
    refs = jax_refs(params, batches)
    return {"worlds": {w: _collect(path, procs)
                       for w, (path, procs) in started.items()},
            "jax": refs, "params": params, "batches": batches}


def case(runs, world, key, rank=0) -> dict:
    return runs["worlds"][world][rank]["cases"][key]


def case_id(world_case) -> str:
    world, (name, shape, mb) = world_case
    return f"{world}-{name}-{shape[0]}x{shape[1]}" + (f"-mb{mb}" if mb > 1
                                                        else "")


def check_metrics(got: list, want: list) -> None:
    for g, w in zip(got, want, strict=True):
        assert sorted(g) == sorted(w)
        H.assert_loss_close(g["loss"], w["loss"], "loss")
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1e-6), (k, g, w)


#: The share of a case's param elements allowed past 1e-6 after three
#: steps: the elements whose AdamW step divides a gradient gap by a
#: small sqrt(v^), at most a few dozen in each case (the tests record
#: the count).
PARAMS_LOOSE_SHARE = 5e-4


def check_params(got, want, metrics: list, grads: list) -> int:
    """Params within 1e-6 of the reference's on all but
    ``PARAMS_LOOSE_SHARE`` of the elements; each of those within what the
    gradient tolerance lets AdamW move it over the steps, at most the
    largest move AdamW can make. AdamW divides a gradient by sqrt(v^) (v
    bias-corrected), so a gradient gap within 1e-4 * max|g| + 1e-7 moves
    an element by up to (the steps' summed lr) x that gap / sqrt(v^), and
    no element moves further than (summed lr) x (1 + weight decay x
    |p|). Returns the number of elements past 1e-6."""
    lr_sum = sum(m["lr"] for m in metrics)
    wd = STEP_CFG["weight_decay"]
    fg = jax.tree_util.tree_flatten_with_path(got.params)[0]
    fw = jax.tree_util.tree_flatten_with_path(want.params)[0]
    fv = jax.tree_util.tree_leaves(want.opt.v)
    gmax = [max(float(np.abs(g).max()) for g in leaf) for leaf in zip(
        *[jax.tree_util.tree_leaves(g) for g in grads])]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    vhat = 1.0 - 0.95 ** STEPS
    over, total = 0, 0
    for (path, g), (_, w), v, gm in zip(fg, fw, fv, gmax):
        tol = 1e-4 * gm + 1e-7
        move = lr_sum * (1.0 + wd * np.abs(w))
        bound = 1e-6 + np.minimum(move,
                                  lr_sum * tol / (np.sqrt(v / vhat) + 1e-8))
        gap = np.abs(g - w)
        worst = np.unravel_index(np.argmax(gap - bound), gap.shape)
        assert np.all(gap <= bound), (jax.tree_util.keystr(path),
                                      gap[worst], bound[worst])
        over += int(np.sum(gap > 1e-6))
        total += gap.size
    assert over <= PARAMS_LOOSE_SHARE * total, (over, total)
    return over


def check_against_jax(runs, world: int, key) -> int:
    """Every rank's metrics equal (the global batch's); rank 0's metrics
    and gathered gradients equal JAX's each step, clipping active; the
    sharded AdamW is the meshless update; the params after three steps
    are JAX's. Returns the number of params past 1e-6."""
    want = runs["jax"][key[0]]
    got = case(runs, world, key)
    for r in range(world):
        assert case(runs, world, key, r)["metrics"] == got["metrics"]
    assert all(m["grad_norm"] > STEP_CFG["clip_norm"]
               for m in want["metrics"])
    check_metrics(got["metrics"], want["metrics"])
    for g, w in zip(got["grads"], want["grads"], strict=True):
        H.assert_grads_close(g, w)
    assert max(got["adamw_gap"]) <= 1e-6
    assert int(got["state"].opt.step) == STEPS
    return check_params(got["state"], want["state"], want["metrics"],
                        want["grads"])


def check_against_meshless(runs, world: int, key) -> int:
    """Rank 0 against the port's meshless step on the global batch (its
    gradients compared where it ran one microbatch). Returns the number
    of params past 1e-6."""
    got = case(runs, world, key)
    want = got["meshless"]
    check_metrics(got["metrics"], want["metrics"])
    for g, w in zip(got["grads"], want["grads"]):
        H.assert_grads_close(g, w)
    assert max(got["adamw_gap"]) <= 1e-6
    return check_params(got["state"], want["state"], want["metrics"],
                        got["grads"])


def spec_blocks(name: str, shape: tuple) -> tuple[dict, int]:
    """Each params leaf's block shape under JAX's ``train_state_pspecs``
    on a (data, model) mesh of ``shape`` (keyed by its '::'-joined path),
    and the bytes of the params and both moments (all fp32)."""
    from repro.distributed.sharding import P
    from test_sharding import FakeMesh
    jcfg, _ = H.configs(name)
    jm = j_get_model(jcfg)
    shapes = jax.eval_shape(lambda k: jts.init_train_state(jm, k),
                            jax.random.PRNGKey(0))
    mesh = FakeMesh({"data": shape[0], "model": shape[1]})
    specs = jts.train_state_pspecs(shapes, mesh, jcfg)
    flat = jax.tree_util.tree_flatten_with_path(shapes.params)[0]
    leaves = jax.tree_util.tree_leaves(specs.params,
                                       is_leaf=lambda x: isinstance(x, P))
    blocks, total = {}, 0
    for (path, leaf), spec in zip(flat, leaves, strict=True):
        dims = []
        for dim, entry in zip(leaf.shape, spec):
            axes = () if entry is None else (entry,) if isinstance(
                entry, str) else entry
            dims.append(dim // int(np.prod([mesh.shape[a] for a in axes])))
        blocks["::".join(str(p.key) for p in path)] = tuple(dims)
        total += int(np.prod(dims)) * 4 * 3
    return blocks, total


def check_state_bytes(runs, world: int) -> None:
    """Each rank's params and moments hold exactly its blocks of JAX's
    specs (layer-axis blocks included), every case of the world."""
    for rank, res in enumerate(runs["worlds"][world]):
        for (name, shape, _), got in res["cases"].items():
            blocks, total = spec_blocks(name, shape)
            assert got["blocks"] == blocks, (name, shape)
            assert got["bytes"] == got["layout_bytes"] == total, \
                (name, shape, rank)
