"""Port parity: ``repro_torch``'s ContinuousBatchingEngine against the JAX
engine (``decode_backend = prefill_backend = "paged_fused"``, classic
whole-prompt prefill) on shared weights and workloads.

Greedy token streams must be identical, and so must the event sequences
(kind, rid, slot, token ordinal, token; timestamps aside) — including an
oversubscribed pool that forces recompute-preemption. Temperature
sampling is held to the JAX formula by feeding both the same Gumbel
noise."""
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
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.core import _sample as j_sample  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request,
)
from repro_torch.serve.core import _sample  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jm, jp, cfg, get_model(cfg), tp


def _requests(cls, vocab, n, rng_seed=0, arrival_gap=0.0, lo=8, hi=50,
              max_new=(3, 12)):
    """The ``tests/test_continuous_batching.py`` workload, for either
    package's Request class — as a burst (all arrivals at t=0): the engine
    clock counts measured compute time, so staggered arrivals would land
    between different steps of two engines that run at different speeds,
    and the event order would follow the machine's load, not the code."""
    rng = np.random.default_rng(rng_seed)
    return [cls(
        rid=i,
        prompt=rng.integers(0, vocab,
                            (int(rng.integers(lo, hi)),)).astype(np.int32),
        max_new_tokens=int(rng.integers(*max_new)),
        arrival_time=i * arrival_gap) for i in range(n)]


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token)
            for e in out["events"]]


def _run_both(engines, reqs_fn, **eng_kw):
    _, jm, jp, _, tm, tp = engines
    jout = JEngine(jm, jp, **eng_kw).run(reqs_fn(JRequest), JGen())
    tout = ContinuousBatchingEngine(tm, tp, device="cpu", **eng_kw).run(
        reqs_fn(Request), GenerationConfig())
    return jout, tout


def test_greedy_streams_and_events_match_jax(engines):
    vocab = engines[3].vocab_size
    jout, tout = _run_both(engines, lambda cls: _requests(cls, vocab, 5),
                           max_slots=3, max_len=128)
    jtok = {r.rid: r.out_tokens for r in jout["requests"]}
    ttok = {r.rid: r.out_tokens for r in tout["requests"]}
    assert ttok == jtok
    assert _events(tout) == _events(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
    assert tout["total_tokens"] == jout["total_tokens"]
    assert tout["mean_active_slots"] == jout["mean_active_slots"] > 1.0


def test_preemption_events_match_jax(engines):
    """Both slots hit a page boundary with the pool dry: the same victim is
    preempted, its token retracted, and both finish identically."""
    cfg = engines[3]
    g = cfg.quant.group_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (g - 2,)).astype(np.int32)
               for _ in range(2)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=40)
                for i, p in enumerate(prompts)]

    jout, tout = _run_both(engines, reqs, max_slots=2, max_len=5 * g,
                           num_pages=4)
    assert any(e[0] == "preempt" for e in _events(tout))
    assert _events(tout) == _events(jout)
    assert {r.rid: r.preemptions for r in tout["requests"]} == \
        {r.rid: r.preemptions for r in jout["requests"]}


def test_temperature_sampling_matches_jax_with_shared_noise():
    """jax.random.categorical is Gumbel-max; the port draws Gumbel noise
    from a torch.Generator, or takes it injected — the same noise must
    pick the same tokens, top-k masking included."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    for gen in (GenerationConfig(temperature=0.7),
                GenerationConfig(temperature=1.3, top_k=5)):
        jgen = JGen(temperature=gen.temperature, top_k=gen.top_k)
        want = np.asarray(j_sample(jnp.asarray(logits), key, jgen))
        noise = np.array(jax.random.gumbel(key, logits.shape))
        got = _sample(torch.from_numpy(logits), gen,
                      noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = _sample(torch.from_numpy(logits), GenerationConfig())
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_sampled_run_completes_and_is_seeded(engines):
    """A temperature run with the port's own generator: every request gets
    its budget, and the session seed fixes the stream."""
    cfg, tm, tp = engines[3], engines[4], engines[5]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=128,
                                   device="cpu")
    gen = GenerationConfig(temperature=0.9, top_k=50, seed=3)
    runs = [eng.run(_requests(Request, cfg.vocab_size, 3, rng_seed=4), gen)
            for _ in range(2)]
    for out in runs:
        assert all(r.done_tokens == r.max_new_tokens for r in out["requests"])
    assert _events(runs[0]) == _events(runs[1])


def test_cancel_releases_slot_and_pages(engines):
    cfg, tm, tp = engines[3], engines[4], engines[5]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=128,
                                   device="cpu")
    core = eng.core
    core.reset(GenerationConfig())
    for r in _requests(Request, cfg.vocab_size, 3, max_new=(20, 21)):
        core.add_request(r)
    evs = []
    while not any(e.kind == "token" for e in evs):
        evs += core.step()
    victim = evs[-1].rid
    free = core.sched.alloc.free_pages
    cancel = core.cancel(victim)
    assert [e.kind for e in cancel] == ["cancel"]
    assert core.sched.alloc.free_pages > free
    assert core.cancel(victim) == []
    after = list(core.events())
    assert after and not any(e.rid == victim for e in after)
    done = {r.rid for r in core.result()["requests"]}
    assert victim not in done and len(done) == 2
