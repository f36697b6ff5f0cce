"""The plain references against the port at debug widths on the CPU,
both in float32 on the same seeded weights: Mixtral's logits over a
whole prompt, and three steps of the Llama block's training recipe."""
import copy

import numpy as np
import pytest
import torch

import cpu_cells
from harness import train, weights
from reference import llama as ref_llama
from reference import mixtral as ref_mixtral

CPU = torch.device("cpu")


def test_mixtral_logits_match_the_port():
    from models import mixtral
    cfg = cpu_cells.debug_configs()["mixtral-debug"]
    model = mixtral.build(cfg, CPU, seed=31)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], 48))
    with torch.no_grad():
        port, _ = model(ids[None])
    ref = ref_mixtral.logits(cfg, 31, [ids], [0], CPU)[0]
    assert port.shape[1:] == ref.shape
    assert float((port[0] - ref).abs().max()) < 1e-4
    # tokens served greedily by the port's plain forward: each is the
    # reference's best too, so every gap is ~0
    seq = ids[:21]
    with torch.no_grad():
        for _ in range(8):
            nxt = model(seq[None])[0][0, -1].argmax()
            seq = torch.cat([seq, nxt[None]])
    served = [int(t) for t in seq[21:]]
    (gaps, ranks), = ref_mixtral.position_readings(
        cfg, 31, [(ids[:21].numpy(), served)], CPU)
    assert gaps.numel() == 8 and float(gaps.max()) < 1e-4
    assert int(ranks.max()) == 0


def test_weights_are_remade_bit_for_bit():
    cfg = cpu_cells.debug_configs()["mistral-debug"]
    groups = ref_llama.weight_groups(cfg)
    a = weights.make_named(groups, "layer_1", 2 ** 31 + 5, CPU)
    b = weights.make_named(groups, "layer_1", 2 ** 31 + 5, CPU)
    c = weights.make_named(groups, "layer_1", 2 ** 31 + 6, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_1.mlp.up_proj.weight"],
                           c["layer_1.mlp.up_proj.weight"])


def test_llama_training_matches_the_port():
    from models import llama

    from ray_tpu_torch.train.spmd import make_train_step
    cfg = copy.deepcopy(cpu_cells.debug_configs()["mistral-debug"])
    cfg["weights"]["compute_dtype"] = "float32"
    opt = dict(cfg["train"]["optimizer"], warmup_steps=2)  # real updates
    cfg["train"]["optimizer"] = opt
    model = llama.build(cfg, CPU, seed=9)
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, cfg["vocab_size"], (1, 65)).astype(np.int64)
            for _ in range(3)]
    state, step = make_train_step(model, llama.optimizer(cfg))(
        {"tokens": torch.from_numpy(rows[0])})
    losses, first = [], {}
    for i, r in enumerate(rows):
        state, m = step(state, {"tokens": torch.from_numpy(r)})
        losses.append(float(m["loss"]))
        if i == 0:
            first = train._first_moments(state, opt["b1"])
    change = train._changes(model, ref_llama.weight_groups(cfg), 9, CPU)
    ref = ref_llama.train(cfg, opt, 9, [torch.from_numpy(r[0]) for r in rows],
                          CPU)
    got = train.compare(losses, first, change, ref)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["step_gap"] < 1e-3
    assert max(ref["change"].values()) > 0


@pytest.mark.parametrize("lr", [0.0, 1e-3])
def test_learning_rate_schedule_matches_the_port(lr):
    from ray_tpu_torch.train.optim import warmup_cosine
    opt = {"peak_lr": 3e-4 + lr, "warmup_steps": 20, "total_steps": 100,
           "end_lr_frac": 0.1}
    sched = warmup_cosine(opt["peak_lr"], 20, 100, 0.1)
    for count in (0, 1, 19, 20, 50, 100, 200):
        assert ref_llama.learning_rate(opt, count) == pytest.approx(
            sched(count))
