"""The port's ``Trainer`` and ``launch/train`` (port of
``tests/test_train.py``'s trainer cases), on the CPU at smoke size:
loss decreases over 40 steps (JAX's criterion: the mean of the last 5
below the mean of the first 5 by more than 0.05), a restart resumes
exactly (steps 11-20 after a restore at 10 equal an uninterrupted run's
within 1e-5), SIGTERM writes an emergency checkpoint and stops, the
quantized cache policy does not touch training, and
``launch.train.main`` trains, checkpoints, resumes and refuses
``--mesh host`` by name."""
import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import StepConfig, Trainer, TrainerConfig  # noqa: E402


@pytest.fixture
def tiny():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    return cfg, get_model(cfg)


def _trainer(m, ds, tc, sc=StepConfig()):
    return Trainer(m, ds, tc, sc, log_fn=lambda *_: None, device="cpu")


def test_loss_decreases(tiny, tmp_path):
    cfg, m = tiny
    ds = SyntheticLMDataset(cfg, global_batch=8, seq_len=64, seed=0)
    tc = TrainerConfig(total_steps=40, checkpoint_every=100,
                       checkpoint_dir=str(tmp_path), log_every=100)
    res = _trainer(m, ds, tc, StepConfig(peak_lr=2e-3, warmup_steps=5,
                                         total_steps=40)).run()
    first, last = np.mean(res["losses"][:5]), np.mean(res["losses"][-5:])
    assert last < first - 0.05, (first, last)


def test_trainer_restart_resumes_exactly(tiny, tmp_path):
    cfg, m = tiny
    d = str(tmp_path / "ck")

    def run(total):
        ds = SyntheticLMDataset(cfg, global_batch=4, seq_len=32, seed=2)
        tc = TrainerConfig(total_steps=total, checkpoint_every=5,
                           checkpoint_dir=d, log_every=100)
        return _trainer(m, ds, tc, StepConfig(peak_lr=1e-3)).run()

    run(10)
    res2 = run(20)                    # restores at 10, continues to 20
    assert res2["final_step"] == 20
    assert len(res2["losses"]) == 10  # only steps 11..20 ran
    shutil.rmtree(d)
    res3 = run(20)
    np.testing.assert_allclose(res3["losses"][10:], res2["losses"],
                               atol=1e-5)


def test_emergency_checkpoint_on_sigterm(tiny, tmp_path):
    cfg, m = tiny
    ds = SyntheticLMDataset(cfg, global_batch=4, seq_len=32, seed=3)
    tc = TrainerConfig(total_steps=50, checkpoint_every=1000,
                       checkpoint_dir=str(tmp_path), log_every=100)
    original = signal.getsignal(signal.SIGTERM)
    try:
        tr = _trainer(m, ds, tc)      # its CheckpointManager takes SIGTERM
        tr.init_or_restore()
        os.kill(os.getpid(), signal.SIGTERM)
        res = tr.run()
    finally:
        signal.signal(signal.SIGTERM, original)
    assert res["final_step"] < 50     # exited early
    assert latest_step(str(tmp_path)) == res["final_step"]


def test_quantized_cache_policy_does_not_affect_training(tiny):
    cfg, _ = tiny
    cfg_q = dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, method="none"))
    m1, m2 = get_model(cfg), get_model(cfg_q)
    b = SyntheticLMDataset(cfg, global_batch=4, seq_len=32,
                           seed=4).next_batch()
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    g = torch.Generator().manual_seed(0)
    p = m1.init(generator=g, device="cpu")
    l1, _ = m1.loss(p, b)
    l2, _ = m2.loss(p, b)
    assert float(l1) == float(l2)


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    args = ["--smoke", "--steps", "6", "--batch", "4", "--seq", "32",
            "--ckpt", str(tmp_path), "--device", "cpu"]
    assert launch_train.main(args) == 0
    assert latest_step(str(tmp_path)) == 6
    assert launch_train.main(["--smoke", "--steps", "8", "--batch", "4",
                              "--seq", "32", "--ckpt", str(tmp_path),
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "restored step=6" in out and "done: final loss" in out
    assert latest_step(str(tmp_path)) == 8


def test_launch_train_refuses_mesh_host(tmp_path, capsys, monkeypatch):
    """``--mesh host`` without the launcher's variables is a world of one:
    the sharded step on a (1, 1) mesh, whose run is the meshless one's
    (the gloo x2 launch: ``tests/test_torch_mesh_train_ckpt.py``)."""
    from repro_torch.launch.mesh import LAUNCHER_VARS
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    args = ["--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
            "--device", "cpu"]
    assert launch_train.main(args + ["--mesh", "host", "--ckpt",
                                     str(tmp_path / "m")]) == 0
    mesh_out = capsys.readouterr().out
    assert "[train] mesh {'data': 1, 'model': 1} over no world" in mesh_out
    assert latest_step(str(tmp_path / "m")) == 4
    assert launch_train.main(args + ["--ckpt", str(tmp_path / "n")]) == 0
    plain_out = capsys.readouterr().out
    assert mesh_out.splitlines()[-1] == plain_out.splitlines()[-1]
