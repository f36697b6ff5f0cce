"""GRPO: group-relative policy optimization for LLM post-training
(counterpart of ray_tpu/rllib/grpo.py).

Per prompt a GROUP of completions is sampled and scored by a reward
function; within-group normalised rewards are the per-sequence
advantages (no value net). The update is a token-level clipped
surrogate with a k3 KL penalty against a frozen reference policy.

Params are a dict name -> tensor, updated in place: a model's own
parameters for full-parameter GRPO (the engine that samples shares the
module, so a step's update is the engine's next policy with no copy),
or the flat adapter dict of train/lora.py over a frozen base.
`apply_fn(params, tokens)` returns logits; for a module it runs
`torch.func.functional_call`, so the frozen reference, a real clone,
scores through the same module.

On the GPU the update's forward runs K1 (flash forward, once in the
forward and once more in the remat recompute) and its backward K2a/K2b;
each log-prob pass runs K1 once (no grad, no remat). Sampling on the
paged engine runs K1 on prefill and K3 on each decode step.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..train.lora import (flatten_adapters, frozen_base, merge_lora,
                          unflatten_adapters)
from ..train.optim import AdamW
from ..util.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GRPOConfig:
    group_size: int = 8
    clip_param: float = 0.2
    kl_coeff: float = 0.04
    lr: float = 1e-5
    grad_clip: float = 1.0
    num_epochs: int = 1
    temperature: float = 1.0
    max_new_tokens: int = 32
    seed: int = 0


def group_relative_advantages(rewards: np.ndarray,
                              group_size: int) -> np.ndarray:
    """[P*G] rewards -> [P*G] advantages, normalized within each group."""
    r = rewards.reshape(-1, group_size)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, keepdims=True)
    return ((r - mean) / (std + 1e-6)).reshape(-1).astype(np.float32)


def _token_logps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits [B,T,V] predicts tokens[:,1:]; returns [B,T-1] log-probs."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return logp.gather(-1, tokens[:, 1:, None].long()).squeeze(-1)


def grpo_optimizer(named, cfg: GRPOConfig) -> AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr)) with
    optax's adamw defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    on every parameter (no mask). Not `make_optimizer("adamw")`, whose
    defaults (b2 0.95, decay 0.1, masked) are the pretraining recipe's."""
    params = [p for _, p in named]
    fused = all(p.is_cuda for p in params) or None
    return AdamW([{"params": params, "weight_decay": 1e-4}], cfg.lr,
                 cfg.grad_clip or None, betas=(0.9, 0.999), eps=1e-8,
                 fused=fused)


def _logits(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def module_apply(model: nn.Module) -> Callable:
    """apply_fn(params, tokens) -> logits of `model` run on `params`."""
    def apply_fn(params, tokens):
        return _logits(functional_call(model, params, (tokens,)))
    return apply_fn


class GRPOLearner:
    """GRPO update over padded token batches.

    apply_fn(params, tokens[B,T]) -> logits [B,T,V] (causal LM). `params`
    (name -> leaf tensor) are trained in place. Batch columns: tokens
    [B,T] int, mask [B,T-1] float32 (1 where position t+1 is a
    completion token to train on), old_logps [B,T-1], ref_logps [B,T-1],
    advantages [B]; numpy or tensors.
    """

    def __init__(self, apply_fn: Callable, params: Mapping[str, torch.Tensor],
                 cfg: GRPOConfig):
        self.cfg = cfg
        self.params: Params = dict(params)
        for p in self.params.values():
            p.requires_grad_(True)
        self.device = next(iter(self.params.values())).device
        self.tx = grpo_optimizer(self.params.items(), cfg)
        self._apply_fn = apply_fn

    def _apply(self, params, tokens) -> torch.Tensor:
        return self._apply_fn(params, tokens) / self.cfg.temperature

    def _tensors(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            out[k] = t.to(self.device, torch.long if k == "tokens"
                          else torch.float32)
        return out

    def loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        logps = _token_logps(self._apply(self.params, batch["tokens"]),
                             batch["tokens"])
        mask = batch["mask"]
        ratio = torch.exp(logps - batch["old_logps"])
        adv = batch["advantages"][:, None]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        # k3 KL estimator vs frozen reference (Schulman)
        logr = batch["ref_logps"] - logps
        kl = torch.exp(logr) - logr - 1.0
        denom = torch.clamp(mask.sum(), min=1.0)
        pg_loss = -(surr * mask).sum() / denom
        kl_loss = (kl * mask).sum() / denom
        loss = pg_loss + cfg.kl_coeff * kl_loss
        return loss, {"pg_loss": pg_loss.detach(), "kl": kl_loss.detach()}

    @torch.no_grad()
    def token_logps(self, params, tokens) -> np.ndarray:
        t = self._tensors({"tokens": tokens})["tokens"]
        return _token_logps(self._apply(params, t), t).cpu().numpy()

    def update(self, batch) -> Dict[str, float]:
        params = list(self.params.values())
        for p in params:
            p.grad = None
        loss, stats = self.loss(self._tensors(batch))
        loss.backward()
        self.tx.step()
        for p in params:
            p.grad = None
        stats["total_loss"] = loss.detach()
        return {k: float(v) for k, v in stats.items()}


class EngineSampler:
    """Group sampling through the serve LLM engine.

    The engine gives GRPO the production decode path (slot KV cache,
    continuous batching, pipelined host loop) instead of the full-forward
    sampling loop. `model` is the engine's module; `params` a state to
    load into it, or None when it already holds the policy (a trainer's
    learner that shares the module). The trainer pushes the updated
    policy with `set_params` after every step.

    The default engine config is the reference's: the contiguous cache
    (no kernels there); pass `engine_cfg` with `kv_page_size > 0` for the
    paged engine, whose prefill runs K1 and decode K3."""

    def __init__(self, model, params, cfg: GRPOConfig, *,
                 eos_id: Optional[int] = None, max_seq_len: int = 512,
                 engine_cfg=None, device: DeviceLike = "cuda"):
        from ..serve.llm import LLMEngine, LLMEngineConfig  # noqa: PLC0415
        if engine_cfg is None:
            engine_cfg = LLMEngineConfig(
                max_slots=min(16, max(2, cfg.group_size)),
                max_seq_len=max_seq_len,
                prefill_buckets=(16, 32, 64, 128, 256),
                max_new_tokens_default=cfg.max_new_tokens,
                eos_token_id=eos_id)
        self.cfg = cfg
        self.engine = LLMEngine(model, params, engine_cfg, device=device,
                                seed=cfg.seed)

    def __call__(self, prompt_ids: Sequence[int], group: int) -> np.ndarray:
        cfg = self.cfg
        plen = len(prompt_ids)
        if plen + cfg.max_new_tokens > self.engine.cfg.max_seq_len:
            # The engine would silently clamp the budget and the trainer
            # would then score/train phantom pad tokens — fail loud.
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({cfg.max_new_tokens})"
                f" exceeds engine max_seq_len "
                f"({self.engine.cfg.max_seq_len}); raise max_seq_len")
        eos = self.engine.cfg.eos_token_id
        rids = [self.engine.submit(prompt_ids,
                                   max_new_tokens=cfg.max_new_tokens,
                                   temperature=max(cfg.temperature, 1e-4))
                for _ in range(group)]
        toks = np.zeros((group, plen + cfg.max_new_tokens), np.int32)
        toks[:, :plen] = np.asarray(prompt_ids, np.int32)
        for g, rid in enumerate(rids):
            comp = list(self.engine.stream(rid))
            toks[g, plen:plen + len(comp)] = comp
            if len(comp) < cfg.max_new_tokens and eos is not None:
                # short (EOS-terminated) completion: pad with EOS so the
                # trainer's mask ends at the true completion length
                toks[g, plen + len(comp):] = eos
        return toks

    def set_params(self, params) -> None:
        # the engine copies between dispatches (nothing when `params` are
        # already its module's own tensors)
        self.engine.set_params(params)

    def shutdown(self) -> None:
        self.engine.shutdown()


class GRPOTrainer:
    """Sample -> score -> group-normalize -> update loop for a causal LM.

    Pass `model=` (a Llama-family module of the port) and sampling
    defaults to the serve LLM engine (EngineSampler) on that same module,
    so the learner's in-place updates are the engine's weights; `params`
    is then a state to load into it first, or None. `apply_fn` is derived
    from the model when omitted. A custom `sampler(prompt_ids, group) ->
    [G, T] tokens` overrides; with neither model nor sampler, a plain
    full-forward loop samples from a generator on the device seeded
    `cfg.seed`. reward_fn(prompt_ids, completion_ids) -> float.

    Runs on `device` (CUDA unless the caller asks for the CPU).
    `timings` holds the last step's seconds of sampling, log-probs and
    update.
    """

    def __init__(self, apply_fn: Optional[Callable] = None, params=None,
                 reward_fn: Callable = None,
                 cfg: Optional[GRPOConfig] = None, *,
                 eos_id: Optional[int] = None,
                 sampler: Optional[Callable] = None,
                 model: Optional[nn.Module] = None, max_seq_len: int = 512,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg or GRPOConfig()
        dev = resolve_device(device)
        if model is not None:
            model.to(dev)
            if params is not None:
                model.load_state_dict(params)
            params = dict(model.named_parameters())
            apply_fn = apply_fn or module_apply(model)
        elif apply_fn is None:
            raise ValueError("need apply_fn or model")
        else:
            params = {k: (v if v.device == dev
                          else v.detach().to(dev).requires_grad_(True))
                      for k, v in params.items()}
        self.learner = GRPOLearner(apply_fn, params, self.cfg)
        # frozen reference: a copy taken once (never the live tensors,
        # which the update writes in place)
        self.ref_params = {k: v.detach().clone() for k, v in params.items()}
        self.reward_fn = reward_fn
        self.eos_id = eos_id
        if sampler is None and model is not None:
            sampler = EngineSampler(model, None, self.cfg, eos_id=eos_id,
                                    max_seq_len=max_seq_len, device=dev)
        self.sampler = sampler
        self._gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        self.timings: Dict[str, float] = {}

    @property
    def params(self) -> Params:
        return self.learner.params

    @torch.no_grad()
    def _sample_group(self, prompt_ids: Sequence[int],
                      group: int) -> np.ndarray:
        """[G, len(prompt)+max_new] sampled completions at the config's
        temperature, one full forward per token."""
        cfg = self.cfg
        plen = len(prompt_ids)
        T = plen + cfg.max_new_tokens
        toks = torch.zeros((group, T), dtype=torch.long,
                           device=self.learner.device)
        toks[:, :plen] = torch.as_tensor(np.asarray(prompt_ids, np.int64))
        for t in range(plen, T):
            logits = self.learner._apply(self.params, toks)[:, t - 1]
            probs = torch.softmax(logits.float(), dim=-1)
            toks[:, t] = torch.multinomial(probs, 1,
                                           generator=self._gen).squeeze(-1)
        return toks.cpu().numpy().astype(np.int32)

    def step(self, prompts: List[Sequence[int]]) -> Dict[str, Any]:
        """One GRPO iteration over a list of tokenized prompts."""
        cfg = self.cfg
        G = cfg.group_size
        t0 = time.perf_counter()
        all_toks, all_masks, rewards = [], [], []
        max_t = 0
        for p in prompts:
            if self.sampler is not None:
                toks = np.asarray(self.sampler(p, G))
            else:
                toks = self._sample_group(p, G)
            plen = len(p)
            mask = np.zeros((G, toks.shape[1] - 1), np.float32)
            for g in range(G):
                comp = toks[g, plen:]
                end = len(comp)
                if self.eos_id is not None:
                    hits = np.nonzero(comp == self.eos_id)[0]
                    if len(hits):
                        end = int(hits[0]) + 1
                # mask[t] trains the prediction of token t+1
                mask[g, plen - 1: plen - 1 + end] = 1.0
                rewards.append(float(self.reward_fn(p, comp[:end])))
            all_toks.append(toks)
            all_masks.append(mask)
            max_t = max(max_t, toks.shape[1])
        toks = np.concatenate([
            np.pad(t, ((0, 0), (0, max_t - t.shape[1]))) for t in all_toks])
        masks = np.concatenate([
            np.pad(m, ((0, 0), (0, max_t - 1 - m.shape[1])))
            for m in all_masks])
        rewards = np.asarray(rewards, np.float32)
        adv = group_relative_advantages(rewards, G)
        t1 = time.perf_counter()
        old_logps = self.learner.token_logps(self.params, toks)
        ref_logps = self.learner.token_logps(self.ref_params, toks)
        t2 = time.perf_counter()
        batch = {"tokens": toks, "mask": masks, "old_logps": old_logps,
                 "ref_logps": ref_logps, "advantages": adv}
        stats: Dict[str, float] = {}
        for _ in range(cfg.num_epochs):
            stats = self.learner.update(batch)
        t3 = time.perf_counter()
        if self.sampler is not None and hasattr(self.sampler, "set_params"):
            self.sampler.set_params(self.params)  # next group: new policy
        self.timings = {"sample_s": t1 - t0, "logps_s": t2 - t1,
                        "update_s": t3 - t2}
        return {"reward_mean": float(rewards.mean()),
                "reward_std": float(rewards.std()), **stats}

    def shutdown(self) -> None:
        if self.sampler is not None and hasattr(self.sampler, "shutdown"):
            self.sampler.shutdown()


def make_lora_grpo_trainer(model: nn.Module, base_params, lora, reward_fn, *,
                           cfg: Optional[GRPOConfig] = None,
                           eos_id: Optional[int] = None,
                           max_seq_len: int = 512, engine_cfg=None,
                           device: DeviceLike = "cuda") -> GRPOTrainer:
    """GRPO over LoRA ADAPTERS: the update trains only the adapters
    (optimizer state O(adapter)), the frozen base (`base_params`, default
    the model's own parameters) is never written, and sampling runs
    through the serve engine on a copy of the module that receives the
    merged weights after every step. The KL reference is the initial
    adapters' policy (the base, since B starts at 0).

    The trainer's params are the flat adapter dict of
    `train.lora.flatten_adapters`."""
    cfg = cfg or GRPOConfig()
    dev = resolve_device(device)
    model.to(dev)
    base = frozen_base(model if base_params is None else base_params)
    meta = {"rank": lora["rank"], "alpha": lora["alpha"]}

    def merged(flat):
        return merge_lora(base, {**meta, "adapters": unflatten_adapters(flat)})

    def apply_fn(flat, tokens):
        return _logits(functional_call(model, merged(flat), (tokens,)))

    flat = {k: v.detach().to(dev).clone()
            for k, v in flatten_adapters(lora["adapters"]).items()}
    trainer = GRPOTrainer(apply_fn=apply_fn, params=flat,
                          reward_fn=reward_fn, cfg=cfg, eos_id=eos_id,
                          device=dev)
    # the engine's own module, holding the merged weights
    engine_model = copy.deepcopy(model).requires_grad_(False)
    with torch.no_grad():
        sampler = EngineSampler(engine_model, merged(trainer.params), cfg,
                                eos_id=eos_id, max_seq_len=max_seq_len,
                                engine_cfg=engine_cfg, device=dev)
    adapted = sorted(lora["adapters"])

    def set_params(flat):
        with torch.no_grad():
            m = merged(flat)
            sampler.engine.set_params({k: m[k] for k in adapted})

    sampler.set_params = set_params
    trainer.sampler = sampler
    return trainer


__all__ = ["GRPOConfig", "group_relative_advantages", "GRPOLearner",
           "EngineSampler", "GRPOTrainer", "make_lora_grpo_trainer",
           "grpo_optimizer", "module_apply"]
