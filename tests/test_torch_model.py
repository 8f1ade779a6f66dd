"""Port parity: the smoke tinyllama (2 layers, fp32) of ``repro_torch``
against the JAX model on the paged serving entries, with the JAX
``init_params`` weights carried over by ``params_from_jax``.

Two slots are prefilled (40 and 17 tokens) and then run 32 batched,
teacher-forced decode steps — crossing quantization-group boundaries, with
one slot idle for a few steps. Prefill and every decode step's logits
must agree within 1e-4 (rtol = atol)."""
import dataclasses

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
from repro.core.cache_layout import PageAllocator, PagedLayout  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout as TLayout  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 32
PROMPTS = ((0, 40), (1, 17))


@pytest.fixture(scope="module")
def both():
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tm = get_model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jm, jp, cfg, tm, tp


def test_configs_agree(both):
    jcfg, _, _, cfg, _, _ = both
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_base", "dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.quant.group_size == jcfg.quant.group_size


def test_prefill_and_decode_logits_match_jax(both):
    jcfg, jm, jp, cfg, tm, tp = both
    g = cfg.quant.group_size
    lay_args = dict(page_size=g, num_pages=16, slots=2, pages_per_slot=6)
    alloc = PageAllocator(PagedLayout(**lay_args))
    jstate = jm.init_paged_state(PagedLayout(**lay_args))
    tstate = tm.init_paged_state(TLayout(**lay_args), "cpu")
    rng = np.random.default_rng(0)
    jprefill = jax.jit(jm.prefill_paged)
    jdecode = jax.jit(jm.decode_paged)
    for slot, tl in PROMPTS:
        assert alloc.alloc(slot, -(-(tl + STEPS) // g))
        toks = rng.integers(0, cfg.vocab_size, (1, 64)).astype(np.int32)
        row = alloc.table_np()[slot]
        jl, jstate = jprefill(jp, jnp.asarray(toks), jstate,
                              jnp.asarray(slot, jnp.int32), jnp.asarray(row),
                              jnp.asarray(tl, jnp.int32))
        tl_, _ = tm.prefill_paged(tp, torch.from_numpy(toks).long(), tstate,
                                  slot, torch.from_numpy(row), tl)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **TOL)
    table = alloc.table_np()
    feed = rng.integers(0, cfg.vocab_size, (STEPS, 2)).astype(np.int32)
    active = np.ones((STEPS, 2), bool)
    active[10:14, 1] = False
    for i in range(STEPS):
        jl, jstate = jdecode(jp, jstate, jnp.asarray(feed[i]),
                             jnp.asarray(table), jnp.asarray(active[i]))
        tl_, _ = tm.decode_paged(tp, tstate, torch.from_numpy(feed[i]).long(),
                                 torch.from_numpy(table),
                                 torch.from_numpy(active[i]))
        live = active[i]
        np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
    # layer-stacked JAX lengths (L, S) against the port's per-layer caches
    jlen = np.asarray(jstate[0].lengths)
    tlen = np.stack([c.lengths.numpy() for c in tstate])
    np.testing.assert_array_equal(tlen, jlen)
    assert tuple(tlen[0]) == (40 + STEPS, 17 + STEPS - 4)


def test_native_init_shapes_and_scales():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    p = get_model(cfg).init(generator=gen, device="cpu")
    assert len(p["layers"]) == cfg.num_layers
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    assert p["layers"][1]["ffn"]["wd"].shape == (cfg.d_ff, cfg.d_model)
