"""The port's boundaries: ``repro_torch`` (and ``chip_smoke.py``) import no
JAX and nothing of the JAX package, entry points refuse to fall back to
the CPU when no card is present, and CPU tensors never launch (or count)
a kernel."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import flash_prefill as fpk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import polar_encode as pek  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, EngineCore, GenerationConfig, Request,
    ServeEngine,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys; import repro_torch, repro_torch.serve, "
            "repro_torch.weights, repro_torch.kernels.ops, "
            "repro_torch.kernels._build; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")


def test_engine_without_device_raises_on_cpu_only_host(no_card):
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    m = get_model(cfg)
    gen = torch.Generator()
    p = m.init(generator=gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(m, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(m, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(m, p, max_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(generator=gen)


def test_dense_cache_without_device_raises_on_cpu_only_host(no_card):
    """``init_cache`` and the model's ``init_decode_state`` are entries
    like the engine: the card unless a device is named."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.quantizers import QuantConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kvc.init_cache(QuantConfig(group_size=32), 1, 2, 32, 64)
    m = get_model(reduce_for_smoke(get_config("tinyllama-1.1b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_decode_state(1, 64, None)
    c = kvc.init_cache(QuantConfig(group_size=32), 1, 2, 32, 64,
                       device="cpu")
    assert c.key_codes.device.type == "cpu"


def test_paged_cache_without_device_raises_on_cpu_only_host(no_card):
    """``init_paged_cache`` is an entry like the engine: the card unless a
    device is named."""
    from repro_torch.core import paged_cache as pgc
    from repro_torch.core.cache_layout import PagedLayout
    from repro_torch.core.quantizers import QuantConfig
    lay = PagedLayout(page_size=32, num_pages=4, slots=1, pages_per_slot=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgc.init_paged_cache(QuantConfig(group_size=32), lay, 2, 32)
    c = pgc.init_paged_cache(QuantConfig(group_size=32), lay, 2, 32,
                             device="cpu")
    assert c.key_codes.device.type == "cpu"


def test_cpu_chunked_prefix_serving_leaves_launch_counters_at_zero():
    from repro_torch.kernels import paged_prefill as ppk
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    m = get_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = m.init(generator=gen, device="cpu")
    before = (pek.launches, pdk.launches, fpk.launches, ppk.launches)
    eng = ContinuousBatchingEngine(m, p, max_slots=2, max_len=128,
                                   prefix_cache=True, device="cpu")
    shared = np.arange(64, dtype=np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate([shared, [i + 1] * 9])
                    .astype(np.int32), max_new_tokens=4,
                    arrival_time=0.0 if i == 0 else 1000.0)
            for i in range(3)]
    out = eng.run(reqs, GenerationConfig())
    assert out["prefill_chunk"] == 64 and out["adopted_pages"] == 4
    assert (pek.launches, pdk.launches, fpk.launches, ppk.launches) == before


def test_cpu_static_serving_leaves_launch_counters_at_zero():
    import dataclasses
    from repro_torch.kernels import paged_prefill as ppk
    from repro_torch.kernels import polar_attention as pak
    from repro_torch.kernels import polar_qk as qkk
    mods = (pek, pdk, fpk, ppk, pak, qkk)
    before = [mod.launches for mod in mods]
    base = reduce_for_smoke(get_config("tinyllama-1.1b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    p = get_model(base).init(generator=gen, device="cpu")
    toks = np.random.default_rng(0).integers(0, base.vocab_size, (2, 40))
    for backend in ("jnp", "paged_fused"):
        m = get_model(dataclasses.replace(base, decode_backend=backend))
        out = ServeEngine(m, p, max_len=64, device="cpu").generate(
            {"tokens": toks}, GenerationConfig(max_new_tokens=4))
        assert out["tokens"].shape == (2, 4)
    assert [mod.launches for mod in mods] == before


def test_cpu_serving_leaves_launch_counters_at_zero():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    m = get_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = m.init(generator=gen, device="cpu")
    before = (pek.launches, pdk.launches, fpk.launches)
    eng = ContinuousBatchingEngine(m, p, max_slots=2, max_len=96,
                                   device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (40,))
                    .astype(np.int32), max_new_tokens=30) for i in range(2)]
    out = eng.run(reqs, GenerationConfig())
    assert all(r.done_tokens == 30 for r in out["requests"])
    assert (pek.launches, pdk.launches, fpk.launches) == before


def test_kernel_build_is_lazy():
    """Importing every port module builds nothing: libraries appear only
    when a kernel is first launched on a CUDA tensor."""
    from repro_torch.kernels import _build

    def built():
        d = _build.BUILD_DIR
        return sorted(p.name for p in d.iterdir()) if d.exists() else None

    before = built()
    code = ("import repro_torch.serve, repro_torch.weights, "
            "repro_torch.kernels.ops, repro_torch.kernels._build")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})
    assert built() == before
