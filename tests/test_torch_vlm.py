"""Port parity: the VLM family (paligemma, ``repro_torch/models/
transformer.py``'s prefix-LM prefill) on the static engine against the
JAX package, and the weights of the VLM and hybrid families.

* ``ServeEngine`` on the smoke paligemma with numpy patch embeddings (the
  stubbed SigLIP frontend), on both static decode routes (the score-only
  LUT path ``"jnp"`` and the fused kernel's ``"paged_fused"``): greedy
  tokens identical to JAX's over 16 steps, prefill logits within 1e-4 and
  the caches held to JAX's (codes equal, a bf16 residual key within one
  bf16 step — ROADMAP §3's standing finding), then every decode step run
  from JAX's state within 1e-4.
* The prefix-LM mask: permuting the patches moves the logits; a later
  text token leaves every earlier position's hidden state as it was; an
  early image position sees a later patch.
* The capacity check counts the frontend's tokens, as JAX's does.
* ``params_from_jax`` carries every leaf of both families (the hybrid's
  period- and tail-stacked layers into layer order), and the native
  ``init_params`` draws the same tree."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hybrid as HY  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402
from repro_torch.weights import init_params, params_from_jax  # noqa: E402

NAME = "paligemma-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
TEXT, STEPS, MAX_LEN = 40, 16, 128   # 16 patches + 40 text: a flush at 63


def t(x):
    """numpy (or JAX) -> torch; bf16 arrays through float32 (exact)."""
    x = np.array(x)
    return torch.from_numpy(x.astype(np.float32) if x.dtype.name ==
                            "bfloat16" else x)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduce(j_get_config(NAME))
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config(NAME))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _batch(cfg, b=2, text=TEXT, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
                np.int32),
            "patches": rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)}


def _torch_batch(batch):
    return {"tokens": t(batch["tokens"]).long(),
            "patches": t(batch["patches"])}


def _jax_layers(jstate):
    """JAX's one-segment stacked caches as one numpy tree per layer."""
    (seg,) = jstate
    tree = jax.tree.map(np.asarray, seg)
    return [jax.tree.map(lambda a, i=i: a[i], tree)
            for i in range(tree.key_codes.shape[0])]


def _cache_buffers(c):
    return {"key_codes": c.key_codes, "key_residual": c.key_residual,
            "value_fp": c.value_fp, "length": c.length, **c.key_scales}


def _check_state(tstate, jstate):
    """Codes and lengths equal; stats and values within 1e-4 (the
    attention tolerance: from the second layer on the keys differ by the
    float32 rounding of the layer below, and a stat set by a short pair
    moves by more than ulps, as in ``tests/test_torch_configs.py``); the
    bf16 residual within one bf16 step (2^-7 relative)."""
    for tc, jc in zip(tstate, _jax_layers(jstate)):
        assert int(tc.length) == int(jc.length) == tc.host_length
        np.testing.assert_array_equal(tc.key_codes.numpy(), jc.key_codes)
        for n, buf in tc.key_scales.items():
            np.testing.assert_allclose(buf.numpy(), jc.key_scales[n], **TOL)
        np.testing.assert_allclose(tc.value_fp.numpy(), jc.value_fp, **TOL)
        np.testing.assert_allclose(tc.key_residual.float().numpy(),
                                   jc.key_residual.astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def _load_state(tstate, jstate):
    """Copy JAX's caches into the port's, in place."""
    for tc, jc in zip(tstate, _jax_layers(jstate)):
        bufs = _cache_buffers(jc)
        for n, dst in _cache_buffers(tc).items():
            dst.copy_(t(bufs[n]).to(dst.dtype))


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_matches_jax(weights, backend):
    jcfg, jp, cfg, tp = weights
    jm = j_get_model(dataclasses.replace(jcfg, decode_backend=backend))
    tm = get_model(dataclasses.replace(cfg, decode_backend=backend))
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jeng = JServe(jm, jp, max_len=MAX_LEN)
    jout = jeng.generate(jb, JGen(max_new_tokens=STEPS + 1))
    tout = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        batch, GenerationConfig(max_new_tokens=STEPS + 1))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes"] == jout["cache_bytes"]
    assert tout["cache_bytes_per_layer"] == jout["cache_bytes_per_layer"]

    jst = jm.init_decode_state(2, MAX_LEN)
    tst = tm.init_decode_state(2, MAX_LEN, "cpu")
    jl, jst = jeng._prefill(jp, jb, jst)
    tl, tst = tm.prefill(tp, _torch_batch(batch), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_state(tst, jst)
    for i in range(STEPS):
        _load_state(tst, jst)
        tok = jout["tokens"][:, i]
        jl, jst = jeng._decode(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.tensor(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # positions go on from the cache length, which counts the image tokens
    assert tst[0].host_length == cfg.frontend_tokens + TEXT + STEPS


def _hidden(tm, tp, batch):
    """The last layer's hidden states (B, F + T, D) of the port's prefill:
    the output of the last block call, captured around ``TF._block``."""
    seen = []
    block = TF._block

    def spy(*a, **kw):
        out = block(*a, **kw)
        seen.append(out[0])
        return out
    st = tm.init_decode_state(batch["tokens"].shape[0], MAX_LEN, "cpu")
    with mock.patch.object(TF, "_block", spy):
        tm.prefill(tp, _torch_batch(batch), st)
    assert len(seen) == tm.cfg.num_layers
    return seen[-1]


def test_prefix_lm_mask_is_bidirectional_over_the_image(weights):
    _, _, cfg, tp = weights
    tm = get_model(cfg)
    f = cfg.frontend_tokens
    batch = _batch(cfg, seed=1)
    base = _hidden(tm, tp, batch)

    # a permutation of the patches moves the logits
    perm = dict(batch, patches=batch["patches"][:, ::-1].copy())
    st = tm.init_decode_state(2, MAX_LEN, "cpu")
    lg0, _ = tm.prefill(tp, _torch_batch(batch), st)
    st = tm.init_decode_state(2, MAX_LEN, "cpu")
    lg1, _ = tm.prefill(tp, _torch_batch(perm), st)
    assert float((lg0 - lg1).abs().max()) > 1e-3

    # a later text token leaves every earlier position alone
    later = dict(batch, tokens=batch["tokens"].copy())
    later["tokens"][:, 30] = (later["tokens"][:, 30] + 1) % cfg.vocab_size
    moved = _hidden(tm, tp, later)
    torch.testing.assert_close(moved[:, :f + 30], base[:, :f + 30], rtol=0,
                               atol=1e-6)
    assert float((moved[:, f + 30:] - base[:, f + 30:]).abs().max()) > 1e-3

    # the first image position sees the last patch (causal would not)
    late = dict(batch, patches=batch["patches"].copy())
    late["patches"][:, f - 1] += 1.0
    moved = _hidden(tm, tp, late)
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-3


def test_capacity_counts_the_frontend_tokens(weights):
    """40 text + 9 new tokens fit 60 slots; with the 16 image tokens they
    do not: both engines refuse with the same message."""
    jcfg, jp, cfg, tp = weights
    batch = _batch(cfg)
    with pytest.raises(ValueError, match="exceeds cache capacity") as te:
        ServeEngine(get_model(cfg), tp, max_len=60, device="cpu").generate(
            batch, GenerationConfig(max_new_tokens=9))
    with pytest.raises(ValueError, match="exceeds cache capacity") as je:
        JServe(j_get_model(jcfg), jp, max_len=60).generate(
            {k: jnp.asarray(v) for k, v in batch.items()},
            JGen(max_new_tokens=9))
    assert str(te.value) == str(je.value)
    out = ServeEngine(get_model(cfg), tp, max_len=64, device="cpu").generate(
        batch, GenerationConfig(max_new_tokens=9))
    assert out["tokens"].shape == (2, 9)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", [NAME, "recurrentgemma-9b"])
def test_params_from_jax_round_trip(name):
    jcfg = j_reduce(j_get_config(name))
    cfg = reduce_for_smoke(get_config(name))
    jp = jax.tree.map(np.asarray, j_get_model(jcfg).init(
        jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, cfg, device="cpu")
    # every JAX leaf lands, exactly, at its port position
    n_jax = 0
    for path, leaf in _leaves(jp):
        n_jax += leaf.size
        if path[0] == "periods":
            kind_key, rest = path[1], path[2:]
            j = int(kind_key[3:kind_key.index("_")])
            pat = len(cfg.block_pattern)
            for p in range(leaf.shape[0]):
                got = tp["layers"][p * pat + j]
                for k in rest:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(), leaf[p])
        elif path[0] == "tail":
            n_periods, pat, tail = HY._period_split(cfg)
            for i in range(leaf.shape[0]):
                got = tp["layers"][n_periods * len(pat) + i]
                for k in path[1:]:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(), leaf[i])
        elif path[0] == "layers":
            grp = {"attn": "attn"}.get(path[1], path[1])
            for i in range(leaf.shape[0]):
                got = tp["layers"][i][grp]
                for k in path[2:]:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(tp[path[0]].numpy(), leaf)
    assert sum(x.numel() for _, x in _leaves(tp)) == n_jax
    if cfg.family == "vlm":
        assert tuple(tp["projector"].shape) == (cfg.frontend_dim,
                                                cfg.d_model)
        assert n_jax == cfg.param_count()
    else:
        # JAX's analytic count takes 2 of the RG-LRU block's 4 width-long
        # vectors (conv_b, rg_b, ig_b, lam): it is 2 * lru_width short per
        # recurrent layer of what init draws; the port keeps JAX's count
        n_rec = HY.layer_types(cfg).count("rec")
        assert n_jax == cfg.param_count() + 2 * cfg.lru_width * n_rec
        assert cfg.param_count() == jcfg.param_count()
    # the native init draws the same tree: keys, shapes and dtypes
    gen = torch.Generator()
    gen.manual_seed(0)
    native = init_params(cfg, generator=gen, device="cpu")
    assert sorted((p, tuple(x.shape), x.dtype) for p, x in
                  _leaves(native)) == \
        sorted((p, tuple(x.shape), x.dtype) for p, x in _leaves(tp))
