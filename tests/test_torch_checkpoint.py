"""The port's checkpoint commit protocol (ray_tpu_torch.train.checkpoint),
mirroring the atomic-commit tests of tests/test_train_ft.py for the JAX
package, and round trips of a Llama state_dict and of a TrainState."""
import os
import time

import pytest
import torch

import ray_tpu_torch.train.checkpoint as ckpt_mod
from ray_tpu_torch.models import Llama, LlamaConfig
from ray_tpu_torch.train import (CheckpointManager, make_optimizer,
                                 make_train_step, restore_pytree,
                                 save_pytree)
from ray_tpu_torch.train.checkpoint import is_committed


def test_torn_save_never_selected_by_latest(tmp_path):
    """latest()/_prune() only consider committed checkpoints: a crash
    mid-save leaves a tmp- staging dir (or a meta-less directory) that
    is never restored."""
    root = str(tmp_path / "ckpts")
    mgr = CheckpointManager(root, num_to_keep=2)
    state = {"w": torch.arange(8, dtype=torch.float32)}
    mgr.save(state, 1)
    assert mgr.latest().metadata()["step"] == 1
    # a torn save: directory exists, data partially written, no meta
    torn = os.path.join(root, "checkpoint_000000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "partial.bin"), "wb") as f:
        f.write(b"\x00" * 16)
    assert not is_committed(torn)
    assert mgr.latest().metadata()["step"] == 1
    # an abandoned staging dir is also invisible
    os.makedirs(os.path.join(root, "tmp-checkpoint_000000003-dead"))
    assert mgr.latest().metadata()["step"] == 1
    # pruning counts only committed dirs and reclaims stale staging
    # dirs (old mtime), never fresh in-flight ones
    old_tmp = os.path.join(root, "tmp-checkpoint_000000004-stale")
    os.makedirs(old_tmp)
    past = time.time() - 2 * CheckpointManager.TMP_TTL_S
    os.utime(old_tmp, (past, past))
    mgr.save(state, 5)
    mgr.save(state, 6)
    mgr.save(state, 7)
    kept = sorted(d for d in os.listdir(root)
                  if d.startswith("checkpoint_")
                  and is_committed(os.path.join(root, d)))
    assert kept == ["checkpoint_000000006", "checkpoint_000000007"]
    assert not os.path.exists(old_tmp)
    assert os.path.exists(os.path.join(
        root, "tmp-checkpoint_000000003-dead"))   # fresh: left alone


def test_crash_mid_save_preserves_previous_checkpoint(tmp_path,
                                                      monkeypatch):
    """A save that dies before the commit rename leaves the previous
    checkpoint at the same path fully intact."""
    path = str(tmp_path / "ck")
    save_pytree({"w": torch.ones(4)}, path, step=1)
    assert is_committed(path)

    def boom(directory, state):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "half"), "wb") as f:
            f.write(b"x")
        raise RuntimeError("crash mid-save")

    monkeypatch.setattr(ckpt_mod, "_write_state", boom)
    with pytest.raises(RuntimeError, match="crash mid-save"):
        save_pytree({"w": torch.zeros(4)}, path, step=2)
    assert is_committed(path)
    restored = restore_pytree(path, map_location="cpu")
    assert torch.equal(restored["w"], torch.ones(4))


def test_crash_between_overwrite_renames_recovers_previous(tmp_path):
    """Overwriting a checkpoint at an existing path slides the old one
    aside before the commit rename; a crash in that window does not lose
    it: latest() promotes the slide-aside copy back."""
    root = str(tmp_path / "cw")
    mgr = CheckpointManager(root, num_to_keep=2)
    mgr.save({"w": torch.ones(4)}, 3)
    base = "checkpoint_000000003"
    os.rename(os.path.join(root, base),
              os.path.join(root, f"tmp-old-{base}-deadbeef"))
    assert not os.path.exists(os.path.join(root, base))
    latest = mgr.latest()
    assert latest is not None and latest.metadata()["step"] == 3
    assert os.path.isdir(os.path.join(root, base))


def test_llama_state_dict_round_trip(tmp_path):
    """A Llama state_dict saved through the manager restores bit for bit
    into a model built from another seed."""
    cfg = LlamaConfig.debug(dtype=torch.float32)
    src = Llama(cfg, device="cpu", seed=1)
    mgr = CheckpointManager(str(tmp_path / "llama"))
    ckpt = mgr.save(src.state_dict(), 10, metadata={"model": "debug"})
    assert ckpt.metadata()["model"] == "debug"
    dst = Llama(cfg, device="cpu", seed=2)
    dst.load_state_dict(restore_pytree(mgr.latest().as_directory(),
                                       map_location="cpu"))
    for name, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], t), name


def test_train_state_round_trip_resumes_the_same_step(tmp_path):
    """TrainState.state_dict() (params, optimizer moments and count)
    saved and loaded into a fresh state: the next step gives the same
    loss and parameters as the uninterrupted run."""
    cfg = LlamaConfig.debug(dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens}

    def run():
        model = Llama(cfg, device="cpu", seed=3)
        return make_train_step(model, make_optimizer(
            "adamw", learning_rate=1e-2))(batch)

    state, step = run()
    state, _ = step(state, batch)
    save_pytree(state.state_dict(), str(tmp_path / "ts"), step=state.step)
    _, want = step(state, batch)
    fresh, fresh_step = run()
    fresh.load_state_dict(restore_pytree(str(tmp_path / "ts"),
                                         map_location="cpu"))
    assert fresh.step == 1 and fresh.opt_state.count == 1
    fresh, got = fresh_step(fresh, batch)
    assert float(got["loss"]) == float(want["loss"])
    for name, p in fresh.params.items():
        assert torch.equal(p, state.params[name]), name


def test_restore_onto_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    save_pytree({"w": torch.ones(2)}, str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_pytree(str(tmp_path / "c"))
