"""The sharded train step's placement and its pieces, in one process (the
cross-process steps are in ``tests/test_torch_mesh_train*.py``).

* ``train_state_pspecs`` on the port's ``state_shapes`` (JAX's stacked
  layout, drawn on the meta device) equals JAX's on ``jax.eval_shape``
  leaves, every config, on ``FakeMesh`` shapes and on (2, 1), (1, 2) and
  (2, 2) — a leaf whose layer axis L is split among them; the layout's
  bytes a rank are the sum of those blocks;
* ``batch_pspecs`` equals JAX's on every family's batch;
* ``global_batch_arrays`` gives each rank the rows of JAX's
  ``local_batch_np`` for its data coordinate (``model`` ranks alike), and
  a dataset built with ``mesh=`` takes the data coordinate as its
  process index;
* a mesh of one: the sharded step equals the meshless step bit for bit,
  every family, microbatches 1 and 2, clipping active;
* a world-of-one sharded save restores any region of a leaf;
* the refusals that remain (``model`` > 1 for the hybrid,
  encoder-decoder and SSM families, by name), and importing the training
  modules leaves JAX out of ``sys.modules``.
"""
import math
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_train_helpers as H  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_configs as j_list_configs  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JData  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint.checkpointing import Block  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.training import make_plan  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import StepConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.sharded import StateLayout, state_shapes  # noqa: E402
from repro_torch.train.train_step import (train_state_pspecs,  # noqa: E402
                                          train_state_to_jax)
from test_sharding import FakeMesh  # noqa: E402

MESHES = ({"model": 2}, {"data": 2, "model": 2}, {"model": 4},
          {"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 1},
          {"data": 1, "model": 2})


class CoordMesh(FakeMesh):
    """A mesh's shape and one rank's coordinates, no world (placement and
    data blocks only)."""

    def __init__(self, shape: dict, coords: dict):
        super().__init__(shape)
        self.coords = coords


def _flat_specs(tree):
    is_p = lambda x: isinstance(x, jsh.P) or isinstance(x, tuple)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


@pytest.fixture(scope="module")
def jax_shapes():
    """Per config: JAX's train state at full size (abstract) and the
    port's ``state_shapes``."""
    out = {}
    for name in j_list_configs():
        jm = j_get_model(j_get_config(name))
        out[name] = (jax.eval_shape(lambda k, jm=jm: jts.init_train_state(
            jm, k), jax.random.PRNGKey(0)), state_shapes(get_config(name)))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_train_state_pspecs_match_jax(jax_shapes, mesh_shape):
    mesh = FakeMesh(mesh_shape)
    for name, (jshapes, shapes) in jax_shapes.items():
        cfg = get_config(name)
        want = jts.train_state_pspecs(jshapes, mesh, j_get_config(name))
        got = train_state_pspecs(shapes, mesh, cfg)
        assert tuple(got.opt.step) == tuple(want.opt.step) == ()
        for part in ("params",):
            assert _flat_specs(getattr(got, part)) == \
                _flat_specs(getattr(want, part)), (name, mesh_shape)
        for part in ("m", "v"):
            assert _flat_specs(getattr(got.opt, part)) == \
                _flat_specs(getattr(want.opt, part)), (name, mesh_shape)


def test_state_shapes_are_jax_eval_shape(jax_shapes):
    for name, (jshapes, shapes) in jax_shapes.items():
        got = jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda x: hasattr(x, "shape"))
        want = jax.tree_util.tree_leaves(jshapes)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want], name


def test_a_layer_axis_is_split():
    """qwen2-moe-a2.7b's ``bq`` (24, 2048) on (2, 1): TP takes its last
    axis (model of one position), FSDP the layer axis."""
    cfg = get_config("qwen2-moe-a2.7b")
    specs = train_state_pspecs(state_shapes(cfg),
                               FakeMesh({"data": 2, "model": 1}), cfg)
    assert tuple(specs.params["layers"]["attn"]["bq"]) == ("data", "model")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_layout_blocks_and_bytes_are_jax_specs(jax_shapes, shape):
    """Each rank's blocks under the port's layout are JAX's spec blocks at
    its coordinates (offsets included), and its bytes their sum, for the
    full-size dense, MoE and VLM configs (meta: no weights drawn)."""
    for name in ("tinyllama-1.1b", "qwen2-moe-a2.7b", "paligemma-3b"):
        cfg = get_config(name)
        mshape = {"data": shape[0], "model": shape[1]}
        want = jts.train_state_pspecs(jax_shapes[name][0], FakeMesh(mshape),
                                      j_get_config(name))
        specs = dict(_flat_specs(want.params))
        for d in range(shape[0]):
            for m in range(shape[1]):
                mesh = CoordMesh(mshape, {"data": d, "model": m})
                lay = StateLayout(get_model(cfg), mesh,
                                  make_plan(cfg, mesh, 8))
                total = 0
                for leaf in lay.leaves:
                    key = "".join(f"['{k}']" for k in leaf.key.split("::"))
                    spec = specs[key]
                    assert tuple(leaf.spec) == spec, (name, key)
                    for dim, entry, blk in zip(leaf.shape, spec, leaf.block):
                        n = mshape[entry] if entry else 1
                        i = {"data": d, "model": m}[entry] if entry else 0
                        assert (blk.start, blk.stop) == (
                            i * dim // n, (i + 1) * dim // n), (name, key)
                    total += math.prod(leaf.block_shape) * 12
                assert lay.state_bytes() == total


FAMILY_BATCH = {"tokens": (8, 33), "patches": (8, 16, 32),
                "frames": (8, 16, 32)}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_batch_pspecs_match_jax(mesh_shape):
    mesh = FakeMesh(mesh_shape)
    specs = {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in FAMILY_BATCH.items()}
    for b in (1, 4, 8, 256):
        assert sh.batch_pspecs(specs, mesh, b) == \
            jsh.batch_pspecs(specs, mesh, b)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "paligemma-3b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)], ids=str)
def test_global_batch_arrays_are_jax_rows(name, shape):
    """The block of data coordinate d: JAX's ``local_batch_np`` of process
    d of n (the tokens; the stub frontend's features are the port's own
    draw, ROADMAP §3), the same on every ``model`` rank; a dataset built
    with ``mesh=`` indexes its process by the data coordinate."""
    jcfg, cfg = H.configs(name)
    seq = 32 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    mshape = {"data": shape[0], "model": shape[1]}
    for d in range(shape[0]):
        jrows = JData(jcfg, global_batch=8, seq_len=seq, seed=2,
                      process_index=d, process_count=shape[0])
        want = jrows.local_batch_np(1)
        for m in range(shape[1]):
            mesh = CoordMesh(mshape, {"data": d, "model": m})
            ds = SyntheticLMDataset(cfg, global_batch=8, seq_len=seq, seed=2,
                                    mesh=mesh)
            assert (ds.process_index, ds.process_count) == (d, shape[0])
            ds.state.step = 1
            got = ds.global_batch_arrays(mesh, ds.batch_pspecs(mesh))
            assert ds.state.step == 2
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            plain = SyntheticLMDataset(cfg, global_batch=8, seq_len=seq,
                                       seed=2, process_index=d,
                                       process_count=shape[0])
            for k, v in plain.local_batch_np(1).items():
                np.testing.assert_array_equal(got[k], v)


def test_global_batch_arrays_whole_batch_where_it_does_not_split():
    """A batch of 6 rows over 4 data positions: ``batch_pspecs`` leaves it
    whole, and every rank gets every row."""
    cfg = H.configs("tinyllama-1.1b")[1]
    mesh = CoordMesh({"data": 4, "model": 1}, {"data": 3, "model": 0})
    ds = SyntheticLMDataset(cfg, global_batch=6, seq_len=32, seed=2,
                            mesh=mesh)
    assert (ds.process_index, ds.process_count) == (0, 1)
    got = ds.global_batch_arrays(mesh, ds.batch_pspecs(mesh))
    np.testing.assert_array_equal(
        got["tokens"], SyntheticLMDataset(cfg, global_batch=6, seq_len=32,
                                          seed=2, process_index=0,
                                          process_count=1).local_batch_np(0)
        ["tokens"])


@pytest.mark.parametrize("name", H.FAMILIES)
def test_mesh_of_one_is_meshless_bit_for_bit(name):
    """On a (1, 1) mesh the sharded step (stacked blocks, the norm from
    per-layer parts, AdamW on blocks) gives the meshless step's metrics
    and state bit for bit over three steps, microbatches 1 and 2, with
    clipping active."""
    _, cfg = H.configs(name)
    model = get_model(cfg)
    seq = 32 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    ds = SyntheticLMDataset(cfg, global_batch=4, seq_len=seq, seed=1)
    batches = [ds.next_batch() for _ in range(3)]
    mesh = make_mesh((1, 1), ("data", "model"))
    for mb in (1, 2):
        sc = StepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                        clip_norm=0.1, ce_chunk=16, microbatches=mb)
        ref = make_train_step(model, None, sc)
        step = make_train_step(model, mesh, sc, global_batch=4)
        st = init_train_state(model, 0, device="cpu")
        ms = step.place(st)
        for b in batches:
            st, m = ref(st, b)
            ms, mm = step(ms, b)
            assert float(m["grad_norm"]) > 0.1
            for k in m:
                assert torch.equal(m[k], mm[k]), (name, mb, k)
        want = tree_leaves(train_state_to_jax(st, cfg))
        got = tree_leaves(step.gather(ms))
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _save_four_ranks(tmp_path, monkeypatch):
    """Four ranks' blocks of a (4, 6) leaf (the fourth a replica, not
    written) saved as the ranks save them: a shard file a rank. Returns
    (the whole leaf, a restore target)."""
    from repro_torch.checkpoint import checkpointing as ck
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    parts = [Block(full[:2, :3], (0, 0), (4, 6), True),
             Block(full[:2, 3:], (0, 3), (4, 6), True),
             Block(full[2:], (2, 0), (4, 6), True),
             Block(full[2:] + 1, (2, 0), (4, 6), False)]
    monkeypatch.setattr(ck, "_barrier", lambda: None)
    for r, blk in enumerate(parts):
        monkeypatch.setattr(ck, "_process", lambda r=r: (r, 4))
        save_checkpoint(str(tmp_path), 1, {"w": blk, "n": Block(
            np.asarray(7, np.int32), (), (), r == 0)}, extra={"step": 1})
    return full, {"w": np.zeros((4, 6), np.float32),
                  "n": np.zeros((), np.int32)}


def test_sharded_save_restores_any_region(tmp_path, monkeypatch):
    """Four ranks' saves (:func:`_save_four_ranks`) with the manifest of
    the world size: JAX's ``restore_checkpoint`` and the port's read it
    whole, and any region restores from the blobs that cover it."""
    from repro.checkpoint import checkpointing as jck
    full, target = _save_four_ranks(tmp_path, monkeypatch)
    for restore in (restore_checkpoint, jck.restore_checkpoint):
        whole, extra = restore(str(tmp_path), 1, target)
        np.testing.assert_array_equal(np.asarray(whole["w"]), full)
        assert int(whole["n"]) == 7 and extra == {"step": 1}
    part, _ = restore_checkpoint(str(tmp_path), 1, target, blocks={
        "w": (slice(1, 3), slice(2, 5)), "n": ()})
    np.testing.assert_array_equal(part["w"], full[1:3, 2:5])
    import json
    with open(tmp_path / "step_0000000001" / "manifest.json") as f:
        assert json.load(f)["process_count"] == 4


def test_restore_reads_only_the_overlapping_blobs(tmp_path, monkeypatch):
    """A region restore reads the blobs that overlap it and no other (a
    blob's shape comes from its header)."""
    full, target = _save_four_ranks(tmp_path, monkeypatch)
    with np.load(tmp_path / "step_0000000001" / "shards-00000.npz") as z:
        npz = type(z)
    read = []
    get = npz.__getitem__
    monkeypatch.setattr(npz, "__getitem__",
                        lambda z, k: read.append(k) or get(z, k))
    part, _ = restore_checkpoint(str(tmp_path), 1, target, blocks={
        "w": (slice(0, 2), slice(3, 6)), "n": ()})
    np.testing.assert_array_equal(part["w"], full[:2, 3:])
    assert sorted(read) == ["n@", "w@0,3"]


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "seamless-m4t-medium",
                                  "mamba2-2.7b"])
def test_tensor_parallel_refused_by_name_for_the_other_families(name):
    _, cfg = H.configs(name)
    mesh = CoordMesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    with pytest.raises(ValueError, match=f"{cfg.family!r} family"):
        make_train_step(get_model(cfg), mesh, global_batch=4)
    data = CoordMesh({"data": 2, "model": 1}, {"data": 1, "model": 0})
    step = make_train_step(get_model(cfg), data, global_batch=4)
    assert step.layout.plan.data_parallel


def test_the_plan_is_seen_from_the_backward_thread():
    """Autograd runs a CUDA backward on a device thread of its own, where
    a remat'd block recomputes its forward: the step's plan must be
    visible there, not only on the thread that installed it."""
    import threading
    from repro_torch.distributed import training as dtrain
    _, cfg = H.configs("tinyllama-1.1b")
    mesh = CoordMesh({"data": 2, "model": 1}, {"data": 0, "model": 0})
    plan = make_plan(cfg, mesh, 4)
    seen = []
    with dtrain.use_plan(plan):
        t = threading.Thread(target=lambda: seen.append(dtrain.current()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [plan]
    assert dtrain.current() is None


def test_rank_rows_are_checked():
    _, cfg = H.configs("tinyllama-1.1b")
    mesh = make_mesh((1, 1), ("data", "model"))
    step = make_train_step(get_model(cfg), mesh, global_batch=4)
    st = step.place(init_train_state(get_model(cfg), 0, device="cpu"))
    b = SyntheticLMDataset(cfg, global_batch=2, seq_len=32).next_batch()
    with pytest.raises(ValueError, match="takes 4 of the global 4"):
        step(st, b)


def test_training_modules_import_no_jax():
    code = ("import sys; import repro_torch.train, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.train.sharded, "
            "repro_torch.models.transformer, repro_torch.distributed.training; "
            "assert 'jax' not in sys.modules, [m for m in sys.modules "
            "if m.startswith('jax')]")
    import os
    env = dict(os.environ, PYTHONPATH=str(H.__file__).rsplit("/tests/", 1)[0]
               + "/src")
    subprocess.run([sys.executable, "-c", code], check=True, env=env)

