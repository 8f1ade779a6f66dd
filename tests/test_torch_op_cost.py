"""The dry run's per-op cost model (``repro_torch/launch/op_cost.py``,
``kernels/work.py``) on the CPU, against JAX's ``hlo_cost.py``.

* a count does not depend on the device: each family the dry run lowers
  (dense, MoE, VLM: train, prefill and decode at smoke size) and each of
  the six kernel wrappers alone count the same on CPU tensors as on meta
  tensors, nothing beneath a wrapper is counted, and a wrapper's meta
  outputs have its CPU outputs' shapes and dtypes;
* CPU and meta mixed still raise;
* a smoke tinyllama step's dot FLOPs lie within 5 % of the dot FLOPs of
  JAX's compiled step (``hlo_cost``'s walk, dots and convolutions only).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import paged_prefill as ppk  # noqa: E402
from repro_torch.kernels import polar_attention as pak  # noqa: E402
from repro_torch.kernels import polar_encode as pek  # noqa: E402
from repro_torch.kernels import polar_qk as qkk  # noqa: E402
from repro_torch.launch import dryrun_lib as lib  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.op_cost import OpCounter  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.train_step import StepConfig, lower_train_step  # noqa: E402


def _smoke(arch):
    return get_model(reduce_for_smoke(get_config(arch)))


def _counts(c: OpCounter) -> tuple:
    return (c.flops, c.dot_flops, c.transcendentals, c.bytes, c.ops,
            {k: dict(v) for k, v in c.kernels.items()}, c.census())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "paligemma-3b"])
def test_family_counts_cpu_equal_meta(arch):
    model = _smoke(arch)
    cfg = model.cfg
    extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
    mesh = make_mesh((1, 1), ("data", "model"))
    for kind, t in (("train", 64), ("prefill", 64 + extra),
                    ("decode", 64 + extra)):
        shape = ShapeConfig(kind, t, 2, kind)
        if kind == "train":
            runs = [lower_train_step(model, None, StepConfig(), 2,
                                     model.input_specs(shape), dev)
                    for dev in ("cpu", "meta")]
        else:
            runs = [lib._serving_step(model, shape, mesh, dev)
                    for dev in ("cpu", "meta")]
        cpu, meta = (r() for r in runs)
        assert _counts(cpu) == _counts(meta), (arch, kind)
        assert cpu.record["argument_bytes"] == meta.record["argument_bytes"]
        assert meta.flops > 0 and meta.kernels, (arch, kind)


def _pools(pp, hkv, g, d, gen):
    codes = torch.randint(0, 256, (pp, hkv, g, d // 2), dtype=torch.uint8,
                          generator=gen)
    stats = [torch.rand((pp, hkv, 1, d // 2), generator=gen) + 0.1
             for _ in range(4)]
    return codes, stats


def _wrapper_calls():
    """Each wrapper called on a small input set: (name, fn(device))."""
    gen = torch.Generator().manual_seed(0)
    s, hkv, qh, d, g, n, pp = 2, 2, 2, 32, 16, 3, 8
    codes, stats = _pools(pp, hkv, g, d, gen)
    vals = torch.randn((pp, hkv, g, d), generator=gen)
    table = torch.tensor([[1, 2, 3], [4, 5, -1]], dtype=torch.int32)
    flushed = torch.tensor([48, 20], dtype=torch.int32)
    q = torch.randn((s, hkv, qh, d), generator=gen)
    gc = 3
    dcodes = torch.randint(0, 256, (s, hkv, gc, g, d // 2),
                           dtype=torch.uint8, generator=gen)
    dstats = [torch.rand((s, hkv, gc, 1, d // 2), generator=gen) + 0.1
              for _ in range(4)]
    dvals = torch.randn((s, hkv, gc * g, d), generator=gen)
    length = torch.tensor([40, 17], dtype=torch.int32)
    k = torch.randn((s, hkv, 2 * g, d), generator=gen)
    pages = torch.tensor([[0, 1], [-1, 2]], dtype=torch.int32)
    fq = torch.randn((1, 4, 24, d), generator=gen)
    fk = torch.randn((1, 2, 24, d), generator=gen)
    tc = 8
    pq = torch.randn((hkv, qh * tc, d), generator=gen)
    kc = torch.randn((hkv, tc, d), generator=gen)
    row = torch.tensor([3, 1, 5], dtype=torch.int32)

    zc = [torch.zeros_like(codes)] + [torch.zeros_like(x) for x in stats]
    return [
        ("polar_encode", pek.polar_encode, [k], {"group_size": g}),
        ("polar_encode_pages", pek.polar_encode_pages, [k, pages, *zc], {}),
        ("paged_decode", pdk.polar_paged_decode_grouped,
         [q, codes, *stats, vals, table, flushed], {}),
        ("flash_prefill", fpk.flash_prefill, [fq, fk, fk],
         {"return_lse": True}),
        ("flash_prefill_local", fpk.flash_prefill, [fq, fk, fk],
         {"mode": "local", "window": 5}),
        ("paged_prefill", lambda *a: ppk.polar_paged_prefill_grouped(
            *a, 2 * g, tc), [pq, kc, kc, codes, *stats, vals, row], {}),
        ("polar_attention", pak.polar_decode_attention_grouped,
         [q, dcodes, *dstats, dvals, length], {}),
        ("polar_qk", qkk.polar_qk_scores, [q, dcodes, *dstats], {}),
    ]


@pytest.mark.parametrize("name,fn,inputs,kw", _wrapper_calls(),
                         ids=[c[0] for c in _wrapper_calls()])
def test_wrapper_counts_cpu_equal_meta(name, fn, inputs, kw):
    outs, counts = {}, {}
    for dev in ("cpu", "meta"):
        xs = [x.to(dev) for x in inputs]
        with OpCounter() as c:
            outs[dev] = fn(*xs, **kw)
        counts[dev] = _counts(c)
        (kname, k), = c.kernels.items()
        assert k["calls"] == 1
        # nothing beneath the wrapper is counted: only its kernel's work
        assert c.flops == k["flops"] and c.bytes == k["bytes"]
        assert c.ops == 0
    assert counts["cpu"] == counts["meta"]
    flat = {d: [o for o in (outs[d] if isinstance(outs[d], tuple)
                            else (outs[d],)) if o is not None]
            for d in outs}
    assert [(tuple(o.shape), o.dtype) for o in flat["cpu"]] == \
        [(tuple(o.shape), o.dtype) for o in flat["meta"]]
    assert all(o.device.type == "meta" for o in flat["meta"])


def test_mixed_cpu_and_meta_still_raise():
    x = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="each alone"):
        fpk.flash_prefill(x, x.to("meta"), x)


# -- FLOPs against JAX's compiled step -----------------------------------------

class _DotsOnly(hlo_cost.HloCostModel):
    """``hlo_cost``'s loop-aware walk with every leaf but dot and
    convolution counted as zero."""

    def _op_cost(self, op, shapes):
        if op.kind in ("while", "fusion", "call", "conditional", "dot",
                       "convolution"):
            return super()._op_cost(op, shapes)
        return hlo_cost.Cost()


def test_smoke_step_dot_flops_near_jax_hlo():
    """Meshless smoke tinyllama (B 4, T 256, block remat). The port counts
    #3's visible causal pairs where JAX's jnp flash attention computes
    its whole T x T chunk (-2.67e8), and its plain flash backward
    recomputes q.k where XLA shares the remat forward's (+1.34e8):
    3.625e9 against 3.758e9, -3.5 %."""
    jc = jcfg.reduce_for_smoke(jcfg.get_config("tinyllama-1.1b"))
    jm = j_get_model(jc)
    st = jax.eval_shape(lambda k: jts.init_train_state(jm, k),
                        jax.random.PRNGKey(0))
    step = jts.make_train_step(jm, None, jts.StepConfig(), global_batch=4,
                               jit=False)
    batch = {"tokens": jax.ShapeDtypeStruct((4, 257), jnp.int32)}
    hlo = jax.jit(step).lower(st, batch).compile().as_text()
    want = _DotsOnly(hlo).total().flops
    model = _smoke("tinyllama-1.1b")
    got = lower_train_step(model, None, StepConfig(), 4,
                           model.input_specs(ShapeConfig("t", 256, 4,
                                                         "train")))()
    gap = (got.dot_flops - want) / want
    assert abs(gap) < 0.05, (got.dot_flops, want, gap)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_resize_and_set_move_no_bytes(dev):
    """``resize_`` and ``set_`` are counted as ops and add no
    traffic-proxy bytes; an op after them does."""
    x, y = torch.zeros(4, device=dev), torch.zeros(16, device=dev)
    with OpCounter() as c:
        x.resize_(16)
        x.set_(y)
        assert c.bytes == 0
        x + 1
    assert c.by_op["resize"] == [1, 0.0, 0] and c.by_op["set"] == [1, 0.0, 0]
    assert c.bytes == 2 * 16 * 4


def test_kernels_and_collectives_do_not_import_the_counter():
    """The wrappers and the collectives report through
    ``repro_torch.cost_hook``; the counter (``launch/op_cost.py``) sits
    above them and is not loaded by importing them."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys; import repro_torch.kernels.flash_prefill, "
            "repro_torch.kernels.paged_decode, "
            "repro_torch.kernels.paged_prefill, "
            "repro_torch.kernels.polar_attention, "
            "repro_torch.kernels.polar_encode, repro_torch.kernels.polar_qk, "
            "repro_torch.distributed.collectives; "
            "print('repro_torch.launch.op_cost' in sys.modules)")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": str(src)})
    assert out.stdout.strip() == "False", out.stderr



# -- the kernel table's bounds from the package's formulas ---------------------

def _bound_rows():
    """(row of PERF.md's kernel table, its Work at chip_smoke's shapes,
    the printed bound, what bounds it)."""
    from repro_torch.kernels import work as W
    g, t, s, sb = 128, 1024, 8, 8
    prefix = 1000 * 1001 // 2 + 256 * 255 // 2    # causal + the prefix block
    rows = [
        ("1", W.encode(1024, 4, 64, g, pages=8), "0.0002", "bytes"),
        ("1 decode", W.encode(g, 4, 64, g, pages=8), "0.00003", "bytes"),
        ("1 fixed", W.encode(1024, 4, 64, g, pages=8, fixed=True), "0.0002",
         "bytes"),
        ("1 d128", W.encode(1024, 8, 128, g, pages=8), "0.0008", "bytes"),
        ("1 d256", W.encode(sb * 7 * g, 1, 256, g), "0.0014", "bytes"),
        ("1 d64 cross", W.encode(sb * 1024, 16, 64, g), "0.0064", "bytes"),
        ("1 mesh2", W.encode(1024, 4, 128, g, pages=8), "0.0004", "bytes"),
        ("3", W.flash_prefill(1, 32, 4, t, t, 64, t * (t + 1) / 2), "0.0043",
         "operations"),
        ("3 d128", W.flash_prefill(1, 32, 8, t, t, 128, t * (t + 1) / 2),
         "0.0087", "operations"),
        ("3 d128 qh1", W.flash_prefill(1, 20, 20, t, t, 128,
                                       t * (t + 1) / 2), "0.0063", "bytes"),
        ("3 d128 qh6", W.flash_prefill(1, 48, 8, t, t, 128, t * (t + 1) / 2),
         "0.0130", "operations"),
        ("3 mesh2", W.flash_prefill(1, 16, 4, t, t, 128, t * (t + 1) / 2),
         "0.0043", "operations"),
        ("3 d256 prefix", W.flash_prefill(sb, 8, 1, 1000, 1000, 256,
                                          sb * prefix), "0.0353",
         "operations"),
        ("3 d256 local", W.flash_prefill(
            sb, 16, 1, 2560, 2560, 256,
            sb * W.visible_pairs("local", 2560, 2560, 2048)), "0.4170",
         "operations"),
        ("3 d64 full", W.flash_prefill(sb, 16, 16, t, t, 64, sb * t * t),
         "0.0347", "operations"),
        ("3 d64 cross", W.flash_prefill(sb, 16, 16, 16, t, 64, sb * 16 * t),
         "0.0102", "bytes"),
        ("3 d64 qh1", W.flash_prefill(sb, 16, 16, 16, 16, 64, sb * 136),
         "0.0003", "bytes"),
        ("3 train", W.flash_prefill(8, 32, 4, 512, 512, 64, 8 * 512 * 513 / 2,
                                    lse=True), "0.0114", "bytes"),
        ("3 train tp2", W.flash_prefill(8, 16, 2, 512, 512, 64,
                                        8 * 512 * 513 / 2, lse=True),
         "0.0057", "bytes"),
    ]
    for label, hkv, qh, d, elt, want in (
            ("2", 4, 8, 64, 2, "0.0016"), ("2u", 4, 8, 64, 1, "0.0011"),
            ("2 d128", 8, 4, 128, 2, "0.0065"),
            ("2 d128 qh1", 20, 1, 128, 2, "0.0161"),
            ("2 d128 qh6", 8, 6, 128, 2, "0.0065"),
            ("2 mesh2", 4, 4, 128, 2, "0.0032")):
        rows.append((label, W.paged_decode(s * 8 * hkv, s=s, hkv=hkv, qh=qh,
                                           d=d, g=g, table=s * 8,
                                           value_elt=elt), want, "bytes"))
    for label, hkv, qh, d, elt, want, by in (
            ("4", 4, 8, 64, 2, "0.0024", "operations"),
            ("4u", 4, 8, 64, 1, "0.0024", "operations"),
            ("4 d128", 8, 4, 128, 2, "0.0049", "operations"),
            ("4 d128 qh1", 20, 1, 128, 2, "0.0044", "bytes"),
            ("4 d128 qh6", 8, 6, 128, 2, "0.0073", "operations"),
            ("4 mesh2", 4, 4, 128, 2, "0.0024", "operations")):
        rows.append((label, W.paged_prefill(hkv=hkv, qh=qh, d=d, g=g,
                                            start=1024, chunk=256,
                                            value_elt=elt), want, by))
    for label, hkv, qh, d, groups, elt, want in (
            ("5", 4, 8, 64, 8, 2, "0.0016"), ("5u", 4, 8, 64, 8, 1, "0.0011"),
            ("5 d128", 8, 4, 128, 8, 2, "0.0065"),
            ("5 d128 qh1", 20, 1, 128, 8, 2, "0.0161"),
            ("5 d128 qh6", 8, 6, 128, 8, 2, "0.0065"),
            ("5 d256 qh8", 1, 8, 256, 8, 2, "0.0016"),
            ("5 d64 qh1", 16, 1, 64, 1, 2, "0.0008"),
            ("5 mesh2", 4, 4, 128, 8, 2, "0.0032")):
        rows.append((label, W.dense_decode(sb * hkv * groups, b=sb, hkv=hkv,
                                           qh=qh, d=d, g=g, value_elt=elt),
                     want, "bytes"))
    for label, hkv, qh, d, groups, want, by in (
            ("6", 4, 8, 64, 9, "0.0008", "bytes"),
            ("6 d128", 8, 4, 128, 9, "0.0020", "bytes"),
            ("6 d128 qh1", 20, 1, 128, 9, "0.0042", "bytes"),
            ("6 d128 qh6", 8, 6, 128, 9, "0.0022", "bytes"),
            ("6 d256 qh8", 1, 8, 256, 9, "0.0005", "bytes"),
            ("6 d256 qh16", 1, 16, 256, 16, "0.0013", "operations"),
            ("6 d64 qh1", 16, 1, 64, 8, "0.0016", "bytes"),
            ("6 mesh2", 4, 4, 128, 9, "0.0010", "bytes")):
        rows.append((label, W.qk_scores(sb * hkv * groups, b=sb, hkv=hkv,
                                        qh=qh, d=d, g=g), want, by))
    return rows


@pytest.mark.parametrize("label,work,want,by", _bound_rows(),
                         ids=[r[0] for r in _bound_rows()])
def test_work_reproduces_kernel_table_bounds(label, work, want, by):
    """Each Bound of PERF.md's kernel table (``chip_smoke.bound`` over
    these formulas at its shapes), to its printed digit."""
    from repro_torch.kernels import work as W
    ms, got_by = W.work_bound(work)
    assert f"{ms:.{len(want.split('.')[1])}f}" == want, (label, ms)
    assert got_by == by
