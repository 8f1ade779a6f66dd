"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU,
held to the port's engines and to JAX's launcher.

Every arm runs the smoke tinyllama with ``--device cpu --batch 2
--prompt-len 16 --gen 6 --max-len 96 --shared-prefix-len 16``:

* each arm's printed first sequence equals the port engine called
  directly on the same params and the same numpy-drawn requests (static,
  cb, cb + prefix cache, streaming, ngram and draft speculation,
  run-ahead, a mixed int8 policy; the static and cb arms also on a
  ``1x1`` mesh);
* JAX's ``repro.launch.serve.main`` and the port's ``serve`` on JAX's
  params crossed with ``params_from_jax`` print the same ``first
  sequence:`` and ``bits/key-elem`` lines (static, cb + prefix cache);
* JAX's TPU execution modes are refused by name, and a mesh of more than
  one position without the launcher's variables exits with how to
  launch it.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.launch import serve as jlaunch  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

BASE = ["--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "6",
        "--max-len", "96", "--shared-prefix-len", "16"]
DEV = ["--device", "cpu"]
#: the arms and the engine options of each
ARMS = {
    "static": [],
    "cb": ["--engine", "cb"],
    "cb-prefix": ["--engine", "cb", "--prefix-cache", "--prefill-chunk",
                  "32"],
    "stream": ["--engine", "cb", "--stream"],
    "ngram": ["--engine", "cb", "--spec-mode", "ngram"],
    "draft": ["--engine", "cb", "--spec-mode", "draft"],
    "runahead": ["--engine", "cb", "--runahead", "4"],
    "int8": ["--int8-layers", "1"],
    "static-mesh1": ["--mesh-shape", "1x1"],
    "cb-mesh1": ["--engine", "cb", "--mesh-shape", "1x1", "--spec-mode",
                 "ngram", "--runahead", "4"],
}


def _lines(fn, *a) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(*a) == 0
    return out.getvalue().splitlines()


def _first(lines) -> list[int]:
    tail = [ln for ln in lines if ln.startswith("[serve] first sequence: ")]
    assert len(tail) == 1 and lines[-1] == tail[0], lines
    return json.loads(tail[0].split(": ", 1)[1])   # a printed int list


def _direct(args, cfg, model, params) -> list[int]:
    """The first sequence of the engine the arm drives, called directly on
    the launcher's requests (drawn here as the launcher draws them)."""
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)
                        ).astype(np.int32)
    gen = GenerationConfig(max_new_tokens=args.gen,
                           temperature=args.temperature, seed=args.seed)
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(args.mesh, ("data", "model"))
    if args.engine == "static":
        eng = ServeEngine(model, params, args.max_len, device="cpu",
                          mesh=mesh)
        return eng.generate({"tokens": toks}, gen)["tokens"][0].tolist()
    shared = rng.integers(0, cfg.vocab_size,
                          (args.shared_prefix_len,)).astype(np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate([shared, toks[i]]),
                    max_new_tokens=args.gen,
                    arrival_time=0.0 if i == 0 else 100.0 + 0.01 * i)
            for i in range(args.batch)]
    spec = (None if args.spec_mode == "off"
            else SpecConfig(mode=args.spec_mode, k=args.spec_k))
    eng = ContinuousBatchingEngine(
        model, params, max_slots=args.batch, max_len=args.max_len,
        device="cpu", mesh=mesh, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, spec=spec, runahead=args.runahead)
    out = eng.run(reqs, gen)
    return [r for r in out["requests"] if r.rid == 0][0].out_tokens


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_prints_the_engine_stream(arm):
    """The launcher's first sequence is the engine's, called directly."""
    args = launch.parse_args(BASE + DEV + ARMS[arm])
    cfg, model, params = launch.build(args)
    lines = _lines(launch.serve, args, cfg, model, params)
    got = _first(lines)
    assert len(got) == args.gen
    assert got == _direct(args, cfg, model, params)
    if arm == "cb-mesh1":
        assert any("runahead h=4  0 horizons" in ln for ln in lines)
        assert lines[0].startswith("[serve] mesh data=1 model=1 over 1 ")


@pytest.fixture(scope="module")
def jax_params():
    """JAX's smoke tinyllama params as its launcher draws them (seed 0),
    as numpy."""
    from repro.configs import get_config, reduce_for_smoke
    from repro.models import get_model
    jm = get_model(reduce_for_smoke(get_config("tinyllama-1.1b")))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arm", ["static", "cb-prefix"])
def test_jax_launcher_and_port_print_the_same(arm, jax_params):
    """JAX's launcher and the port's ``serve`` on JAX's params (drawn as
    its launcher draws them) print the same first sequence and key
    bits."""
    np_params = jax_params
    argv = BASE + ARMS[arm]
    jl = _lines(jlaunch.main, argv)
    args = launch.parse_args(argv + DEV)
    cfg, model, _ = launch.build(args)
    tl = _lines(launch.serve, args, cfg, model,
                params_from_jax(np_params, cfg, device="cpu"))
    assert _first(tl) == _first(jl)
    bits = [ln for ln in tl if "bits/key-elem" in ln]
    assert bits == [ln for ln in jl if "bits/key-elem" in ln]


@pytest.mark.parametrize("flag", ["--decode-backend", "--prefill-backend"])
@pytest.mark.parametrize("mode", ["ref", "interpret", "pallas"])
def test_tpu_execution_modes_are_refused_by_name(flag, mode, capsys):
    with pytest.raises(SystemExit):
        launch.parse_args(BASE + DEV + [flag, mode])
    err = capsys.readouterr().err
    assert f"{flag} {mode!r} is a TPU execution mode" in err


def test_mesh_without_the_launcher_exits_with_how_to_launch(monkeypatch):
    for var in launch.LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=r"torch\.distributed\.run "
                       r"--nproc_per_node 2 .*--mesh-shape 1x2"):
        launch.main(BASE + DEV + ["--mesh-shape", "1x2"])
    with pytest.raises(SystemExit, match="bad --mesh-shape"):
        launch.parse_args(BASE + DEV + ["--mesh-shape", "2by1"])


def test_no_card_and_no_device_raises():
    """The launcher never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(BASE)
