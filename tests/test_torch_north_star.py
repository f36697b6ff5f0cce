"""The north star end to end on the port, on the CPU
(tests/test_north_star.py's chain and sizes): pretrain a Llama-family
decoder -> checkpoint -> restore -> serve it on the continuous-batching
engine -> GRPO post-train through that engine. Every stage is the port's
production path; the assertions are the reference test's.
"""
import numpy as np
import torch

from ray_tpu_torch.models import Llama, LlamaConfig
from ray_tpu_torch.rllib import EngineSampler, GRPOConfig, GRPOTrainer
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                 restore_pytree, save_pytree)


def test_pretrain_checkpoint_serve_grpo(tmp_path):
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=64, max_seq_len=64, remat=False,
                      dtype=torch.float32, param_dtype=torch.float32)
    model = Llama(cfg, device="cpu", seed=0)
    tx = make_optimizer("adamw", learning_rate=5e-3)

    # --- 1. pretrain: loss must drop on a repeating corpus ---
    rng = np.random.RandomState(0)
    corpus = rng.randint(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": torch.from_numpy(corpus)}
    state, step = make_train_step(model, tx)(batch)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses

    # --- 2. checkpoint + restore ---
    ckpt_dir = str(tmp_path / "ckpt")
    save_pytree(model.state_dict(), ckpt_dir)
    params = restore_pytree(ckpt_dir, map_location="cpu")

    # --- 3. serve on the continuous-batching engine ---
    eng = LLMEngine(Llama(cfg, device="cpu", seed=99), params,
                    LLMEngineConfig(max_slots=2, max_seq_len=64,
                                    prefill_buckets=(16,)), device="cpu")
    try:
        prompt = corpus[0, :8]
        toks = eng.generate_sync(prompt, max_new_tokens=6,
                                 temperature=0.0)
        assert len(toks) == 6
        # the pretrained model continues the memorized corpus better
        # than chance: its greedy continuation matches the true next
        # tokens at least once in 6
        truth = corpus[0, 8:14]
        assert sum(int(t == u) for t, u in zip(toks, truth)) >= 1
    finally:
        eng.shutdown()

    # --- 4. GRPO post-train THROUGH the engine sampler ---
    target = int(corpus[0, 0])

    def reward(prompt_ids, completion_ids):
        return float(sum(1 for t in completion_ids if t == target))

    trainer = GRPOTrainer(params=params, reward_fn=reward,
                          model=Llama(cfg, device="cpu", seed=98),
                          max_seq_len=64,
                          cfg=GRPOConfig(group_size=4, max_new_tokens=8,
                                         lr=5e-3, temperature=1.0),
                          device="cpu")
    try:
        assert isinstance(trainer.sampler, EngineSampler)
        stats = [trainer.step([list(prompt)]) for _ in range(6)]
    finally:
        trainer.shutdown()
    early = np.mean([s["reward_mean"] for s in stats[:2]])
    late = np.mean([s["reward_mean"] for s in stats[-2:]])
    # post-training through the serve engine moves reward the right way
    assert late >= early - 0.5, (early, late)
    assert all(np.isfinite(s["total_loss"]) for s in stats)
