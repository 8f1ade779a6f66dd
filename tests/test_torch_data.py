"""The port's synthetic data pipeline (``repro_torch/data``; port of
``tests/test_data.py``): tokens bit-equal to JAX's
``SyntheticLMDataset`` for every family, deterministic in (seed, step),
resume replays the stream, host sharding partitions the batch, the
stream is learnable, and the VLM's ``patches`` / the encoder-decoder's
``frames`` (numpy normals from (seed, step), where JAX draws
``jax.random``) are deterministic and move with the step."""
from collections import Counter, defaultdict

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402

FAMILIES = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "paligemma-3b",
            "recurrentgemma-9b", "seamless-m4t-medium", "mamba2-2.7b")


def _ds(name="tinyllama-1.1b", **kw):
    cfg = reduce_for_smoke(get_config(name))
    return SyntheticLMDataset(cfg, global_batch=kw.pop("gb", 8),
                              seq_len=kw.pop("sl", 64), **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_tokens_bit_equal_to_jax(name):
    jds = JDataset(j_reduce(j_get_config(name)), global_batch=4, seq_len=48,
                   seed=6)
    ds = _ds(name, gb=4, sl=48, seed=6)
    for step in (0, 3):
        want = jds.local_batch_np(step)
        got = ds.local_batch_np(step)
        assert sorted(got) == sorted(want)
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        for k in set(got) - {"tokens"}:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == want[k].dtype == np.float32


def test_deterministic_in_seed_and_step():
    a = _ds(seed=1).local_batch_np(step=5)
    b = _ds(seed=1).local_batch_np(step=5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = _ds(seed=2).local_batch_np(step=5)
    assert not np.array_equal(a["tokens"], c["tokens"])


@pytest.mark.parametrize("name,key", [("paligemma-3b", "patches"),
                                      ("seamless-m4t-medium", "frames")])
def test_frontend_features_deterministic(name, key):
    a = _ds(name, seed=1, sl=48).local_batch_np(step=2)[key]
    b = _ds(name, seed=1, sl=48).local_batch_np(step=2)[key]
    np.testing.assert_array_equal(a, b)
    c = _ds(name, seed=1, sl=48).local_batch_np(step=3)[key]
    assert not np.array_equal(a, c)
    assert abs(float(a.std()) - 1.0) < 0.1


def test_resume_replays_exact_stream():
    ds = _ds(seed=3)
    seen = [ds.next_batch()["tokens"] for _ in range(4)]
    ds2 = _ds(seed=3)
    ds2.state.step = 2
    np.testing.assert_array_equal(ds2.next_batch()["tokens"], seen[2])
    np.testing.assert_array_equal(ds2.next_batch()["tokens"], seen[3])


def test_host_sharding_partitions_batch():
    full = _ds(seed=4, process_index=0, process_count=1).local_batch_np(0)
    h0 = _ds(seed=4, gb=8, process_index=0, process_count=2).local_batch_np(0)
    h1 = _ds(seed=4, gb=8, process_index=1, process_count=2).local_batch_np(0)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), full["tokens"])


def test_process_defaults_without_a_group():
    ds = _ds()
    assert (ds.process_index, ds.process_count) == (0, 1)


def test_stream_is_learnable():
    toks = _ds(seed=5, gb=16, sl=256).next_batch()["tokens"]
    ctx = defaultdict(Counter)
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            ctx[int(a)][int(b)] += 1
    top_frac = np.mean([max(v.values()) / sum(v.values())
                        for v in ctx.values() if sum(v.values()) > 3])
    assert top_frac > 0.5, top_frac
