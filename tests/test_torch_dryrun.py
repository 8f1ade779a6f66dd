"""The port's dry run (``repro_torch/launch/dryrun_lib.py``) against JAX's
(``repro/launch/dryrun_lib.py``), on the CPU; its cost model is held in
``tests/test_torch_op_cost.py``.

* ``ARCH_IDS``, ``SHAPES`` and ``should_skip`` are JAX's;
* ``make_production_mesh`` has JAX's axes and shapes on a fake world, and
  rank r sits at the row-major coordinates ``jax.make_mesh`` gives
  device r;
* tinyllama-1.1b ``train_4k`` at full width on both production meshes:
  the record's state bytes are JAX's per-device bytes under
  ``train_state_pspecs`` (98,746,372 on (16, 16)), its batch bytes
  JAX's ``batch_pspecs`` rows, and two ranks that write the same leaves
  give equal records;
* a decode cell's ``jax_argument_bytes`` are JAX's per-device bytes from
  JAX's own trees and resolvers;
* refused cells (the hybrid, encoder-decoder and SSM families' train
  cells) carry the port's named error, skips JAX's reason, and no world
  outlives a cell;
* the serving cells of those three families place their states as
  ``ServeEngine(mesh=)`` does: each part's bytes the meshless part's
  over the split ``serving_rules`` gives.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import dryrun_lib as jlib  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import configs as cfgs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun_lib as lib  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from test_sharding import FakeMesh  # noqa: E402

PROD = {"single": {"data": 16, "model": 16},
        "multi": {"pod": 2, "data": 16, "model": 16}}


def test_arch_ids_shapes_and_skips_are_jax():
    assert cfgs.ARCH_IDS == jcfg.ARCH_IDS
    assert sorted(cfgs.SHAPES) == sorted(jcfg.SHAPES)
    for name, s in cfgs.SHAPES.items():
        j = jcfg.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    for arch in cfgs.ARCH_IDS:
        for name in cfgs.SHAPES:
            assert lib.should_skip(get_config(arch), cfgs.SHAPES[name]) == \
                jlib.should_skip(jcfg.get_config(arch), jcfg.SHAPES[name])


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_is_jax_layout(kind, monkeypatch):
    asked = []
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes: asked.append((shape, axes)))
    jmesh.make_production_mesh(multi_pod=kind == "multi")
    (shape, axes), = asked
    n = math.prod(shape)
    for rank in (0, 1, 17, n - 1):
        with lib.fake_world(n, rank):
            mesh = make_production_mesh(multi_pod=kind == "multi")
            assert mesh.axis_names == axes
            assert tuple(mesh.shape.values()) == shape
            # jax.make_mesh lays devices out row-major over the shape
            want = np.unravel_index(rank, shape)
            assert tuple(mesh.coords[a] for a in axes) == tuple(want)
            assert len(mesh.groups) == len(axes)
        assert not dist.is_initialized()


def _jax_train_bytes(arch: str, mesh_shape: dict, gb: int, t: int):
    """JAX's per-device state and batch bytes of a train cell."""
    jm = j_get_model(jcfg.get_config(arch))
    st = jax.eval_shape(lambda k: jts.init_train_state(jm, k),
                        jax.random.PRNGKey(0))
    mesh = FakeMesh(mesh_shape)
    specs = jts.train_state_pspecs(st, mesh, jcfg.get_config(arch))
    leaves = jax.tree_util.tree_leaves(st)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jsh.P))

    def dev_bytes(shape, itemsize, spec):
        n = math.prod(shape)
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n //= mesh.shape[a]
        return n * itemsize
    state = sum(dev_bytes(x.shape, x.dtype.itemsize, s)
                for x, s in zip(leaves, sp))
    bs = jsh.batch_pspecs({"tokens": jax.ShapeDtypeStruct(
        (gb, t + 1), jnp.int32)}, mesh, gb)["tokens"]
    return state, dev_bytes((gb, t + 1), 4, bs)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_train_cell_bytes_are_jax(kind, tmp_path):
    shape = cfgs.SHAPES["train_4k"]
    state, batch = _jax_train_bytes("tinyllama-1.1b", PROD[kind],
                                    shape.global_batch, shape.seq_len)
    if kind == "single":
        assert state == 98_746_372
    # ranks off coordinate 0 on every axis write the same leaves' norm
    # parts (a replicated leaf's part comes from its coordinate-0 rank)
    ranks = (17, 255) if kind == "single" else (0,)
    recs = [lib.run_cell("tinyllama-1.1b", "train_4k", kind, str(tmp_path),
                         kind, rank=r) for r in ranks]
    for rec in recs:
        assert rec["status"] == "ok" and rec["placement"] == "train_pspecs"
        assert rec["state_bytes"] == state, rec["state_bytes"] - state
        assert rec["batch_bytes"] == batch
        assert rec["jax_argument_bytes"] == state + batch
        assert rec["memory"]["argument_bytes"] == state + batch
        assert rec["cost"]["flops"] > rec["dot_flops"] > 0
        assert rec["kernel_calls"] == {"flash_prefill": 44}
        assert rec["collectives"]["total_bytes"] > 0
        assert rec["hardware"]["peak_flops"] == 989e12
        assert not dist.is_initialized()
    if len(recs) == 2:
        a, b = recs
        assert a["coords"] != b["coords"]
        for key in ("memory", "cost", "dot_flops", "kernel_calls",
                    "collectives", "state_bytes", "batch_bytes"):
            assert a[key] == b[key], key


def _jax_decode_bytes(arch: str) -> int:
    """JAX's per-device argument bytes of ``arch``'s ``decode_32k`` cell on
    the (16, 16) mesh, from JAX's own trees and resolvers."""
    shape = cfgs.SHAPES["decode_32k"]
    mesh = FakeMesh(PROD["single"])
    jc = jcfg.get_config(arch)
    jm = j_get_model(jc)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    state = jm.decode_state_specs(jcfg.SHAPES["decode_32k"])

    def tree_bytes(tree, specs):
        leaves = jax.tree_util.tree_leaves(tree)
        sp = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jsh.P))
        assert len(leaves) == len(sp)
        total = 0
        for x, s in zip(leaves, sp):
            n = math.prod(x.shape)
            for e in s:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n //= mesh.shape[a]
            total += n * x.dtype.itemsize
        return total
    return tree_bytes(params, jsh.param_pspecs(params, mesh, jc)) \
        + tree_bytes(state, jsh.decode_state_pspecs(state, mesh,
                                                    shape.global_batch)) \
        + shape.global_batch // 16 * 4


def test_decode_cell_jax_bytes_from_jax_trees():
    """``jax_argument_bytes`` of a decode cell: fp32 params under
    ``param_pspecs``, the stacked decode state under
    ``decode_state_pspecs``, the token under ``batch_pspecs`` — the same
    sum from JAX's own trees and resolvers."""
    arch = "tinyllama-1.1b"
    mesh = FakeMesh(PROD["single"])
    got = lib.jax_argument_bytes(get_model(get_config(arch)),
                                 cfgs.SHAPES["decode_32k"], mesh)
    assert got == _jax_decode_bytes(arch)


# -- statuses and the world's lifetime -----------------------------------------

def test_refused_and_skipped_cells(tmp_path):
    """The cells still refused are the train cells of the hybrid,
    encoder-decoder and SSM families (training's tensor parallelism over
    ``model``); JAX's skip rule holds."""
    for arch, family in (("mamba2-2.7b", "ssm"),
                         ("recurrentgemma-9b", "hybrid"),
                         ("seamless-m4t-medium", "encdec")):
        rec = lib.run_cell(arch, "train_4k", "single", str(tmp_path),
                           "single")
        assert rec["status"] == "refused"
        assert ("make_train_step: tensor parallelism over 'model' is not "
                f"ported for the {family!r} family") in rec["reason"]
        assert not dist.is_initialized()
    rec = lib.run_cell("yi-9b", "long_500k", "multi", str(tmp_path), "multi")
    assert rec["status"] == "skip"
    assert rec["reason"] == jlib.should_skip(jcfg.get_config("yi-9b"),
                                             jcfg.SHAPES["long_500k"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "seamless-m4t-medium",
                                  "mamba2-2.7b"])
def test_serving_cell_of_a_recurrent_or_encdec_family(arch, tmp_path):
    """``decode_32k`` of the hybrid, encoder-decoder and SSM families on the
    (16, 16) mesh runs under the static engine's placement: the record's
    state bytes are the meshless state's parts (at the rank's rows) over
    the split where ``serving_rules`` splits them — seamless's self and
    cross caches over its 16 KV heads, recurrentgemma's RG-LRU states over
    its width (its one-KV-head rings whole), mamba2's SSD states over its
    80 heads and its conv windows to the block's ``xin`` channels plus
    every B/C channel — and the length scalars whole; its
    ``jax_argument_bytes`` are JAX's from JAX's own trees (the hybrid's
    period / tail stacks, the encoder-decoder's self / cross dict)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.registry import state_part_bytes
    from repro_torch.utils import tree_bytes
    rec = lib.run_cell(arch, "decode_32k", "single", str(tmp_path), "single")
    assert rec["status"] == "ok" and rec["placement"] == "serving"
    assert not dist.is_initialized()
    assert rec["jax_argument_bytes"] == _jax_decode_bytes(arch)
    cfg = get_config(arch)
    shape = cfgs.SHAPES["decode_32k"]
    meshless = get_model(cfg).init_decode_state(rec["rows"], shape.seq_len,
                                                "meta")
    parts = state_part_bytes(meshless)
    n = 16
    want = {"hybrid": {"kv_heads": None, "rec_width": (0, n)},
            "encdec": {"kv_heads": (0, n)},
            "ssm": {"ssm_heads": (0, n)}}[cfg.family]
    assert rec["state_blocks"] == want
    split = {"self": n, "cross": n, "ring": 1, "rg_conv": n, "rg_h": n,
             "ssd": n}
    total = tree_bytes(meshless) - sum(parts.values())   # the lengths
    for part, b in parts.items():
        if part == "ssd_conv":
            dm = M2.dims(cfg)
            total += b // dm.conv_dim * (dm.d_inner // n
                                         + 2 * dm.ngroups * dm.dstate)
        else:
            total += b // split[part]
    assert rec["state_bytes"] == total, (rec["state_bytes"], total)


def test_world_gone_after_a_failing_cell_and_refused_inside_one(tmp_path,
                                                                monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("lowering failed")
    monkeypatch.setattr(lib, "lower_cell", boom)
    with pytest.raises(RuntimeError, match="lowering failed"):
        lib.run_cell("tinyllama-1.1b", "decode_32k", "single",
                     str(tmp_path), "single")
    assert not dist.is_initialized()
    with lib.fake_world(4):
        with pytest.raises(RuntimeError, match="already up"):
            lib.run_cell("tinyllama-1.1b", "train_4k", {"data": 4},
                         str(tmp_path), "t")
    assert not dist.is_initialized()


def test_input_specs_are_jax_token_specs():
    """``Model.input_specs`` of every dry-run arch and shape: JAX's
    ``_token_specs`` names, shapes and dtypes."""
    for arch in cfgs.ARCH_IDS:
        port = get_model(get_config(arch))
        jm = j_get_model(jcfg.get_config(arch))
        for name, shape in cfgs.SHAPES.items():
            got = port.input_specs(shape)
            want = jm.input_specs(jcfg.SHAPES[name])
            assert sorted(got) == sorted(want), (arch, name)
            for k, v in want.items():
                assert tuple(got[k].shape) == v.shape, (arch, name, k)
                assert str(got[k].dtype).split(".")[-1] == str(v.dtype)
