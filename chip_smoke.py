#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel from `ray_tpu_torch/csrc/`, then runs
twenty-one phases and fails (non-zero exit, no result line) if any of them fails:

1. kernels: each kernel against its plain PyTorch version at
   Llama-3-8B attention shapes (Hq 32, Hkv 8, D 128, bf16; K1 and
   K2a/K2b also at the flagship's D 64 in bf16 and fp32, D 32 and 16,
   ragged lengths and Hq = Hkv, and two launches compared bit for bit;
   K1 also at the zoo's bf16 shapes: ViT-base's non-causal S 197 and
   GPT-2 small's prefills, 12/12 heads of D 64; K3 also at the edges of
   its key splits, rep 1 and 16, D 64, page 8, fp32 and GPT-2 small's
   decode) and, for K4 (RMSNorm), at the
   shapes its callers use (1 to 2 x 2048 rows of 4096, bf16 with an
   fp32 weight) and at the edges of each of its routes, with the
   tolerance printed; K4's backward against plain autograd; kernel,
   plain and library times on the card and the least time the card
   could take (the bound), K4's at 4096 rows and at a decode step's 8;
   the wgmma kernels' and K4's registers and spills from the ptxas log
   (a spill fails).
2. serve: `LLMServer` on Llama-3-8B widths at full depth (32 layers,
   bf16, random weights from a seed), one model under every engine
   configuration. First (v) precompile: the first request's TTFT on a
   fresh paged engine (chunked prefill, prefixes) without precompile,
   with `precompile()` (its wall time printed; every slot free after),
   and without it again. Then bursts of 8 requests of 32 new tokens
   each (greedy, one temperature/top_p, one streamed): the paged cache
   (profiled a second time); (i) the contiguous cache; (ii) paged with
   chunked prefill (512) and decode_block 4, beside the same with
   decode_block 1 and with decode_block 4 under a pipeline of 3
   dispatches (the TPOT of each printed together); (iii) paged with one
   1000-token prefix registered and 8 requests of prefix + suffix; (iv)
   serve-spec: repetitive greedy prompts, plain and with
   ngram_speculation=4 (verify steps, accepted tokens a step, TTFT,
   TPOT and decode tokens/s of both); a guided burst (choices of token
   ids) and a penalised one (presence, frequency, logit_bias). Every
   request must finish with in-vocab tokens; the launch counters of K1
   and K3, zeroed just before each burst, must have grown where the
   path runs them (and stayed at 0 on the contiguous cache); the prefix
   saved 8 x 1000 prefill tokens, and its registration launched K1.
3. parity: at the same widths with 4 layers in fp32 (TF32 off), the
   engine's greedy tokens in nine configurations (paged; contiguous
   with prefill batches of 1 and 4; chunked prefill, decode_block 4 and
   a prefix request on each cache) must equal a full-recompute greedy
   loop through the same model with no cache and its attention held to
   the einsum path (`einsum_attention`; no kernel launches there,
   checked).
4. controls: at the parity phase's shape, on the paged and the
   contiguous cache, the request controls held to the same
   full-recompute loop with the engine's rules applied on the host:
   n-gram speculation (K 4; tokens identical, verify steps with
   accepted proposals, fewer decode dispatches than tokens), presence
   and frequency penalties and logit_bias (+100 forces a token, -100
   blocks one), guided choices of token ids alone and with penalties
   (outputs accepted by the FSM), logprobs within LOGPROB_ATOL of the
   loop's fp32 log_softmax; an expired deadline raises
   DeadlineExceededError, and a stall past the watchdog makes the
   stream raise EngineWedgedError and LLMServer.check_health raise.
5. routes: the paged engine at 2 layers of head dim 96 (Phi-3-mini
   widths) and of MQA (Llama-3-8B widths, one kv head) in fp32, greedy
   tokens equal to the same full-recompute loop, and an fp16 burst at
   Llama-3-8B widths with in-vocab tokens: K3 is launched in none of
   them (K1 only on the MQA prefills), as the routes by shape and type
   say.
6. zoo: every model family the engine serves. (a) Mixtral-8x7B widths
   (d 4096, 32/8 heads, 8 experts top-2, capacity factor 1.25) with the
   depth cut from 32 to 8 layers (23.7 GB in bf16; 32 layers are 93 GB),
   bf16 random weights: a paged burst of 8 requests (prompts of 20-500
   tokens), K1 and K3 launched, in-vocab tokens, TTFT, TPOT, decode
   tokens/s and peak memory printed; then 2 fp32 layers at the no-drop
   capacity (capacity_factor = n_experts / experts_per_token: the
   capacity is the call's token count) on the paged and the contiguous
   engine, token-identical to the einsum loop. (b) int8: the serve
   phase's Llama-3-8B quantized on the card (`quantize_llama_params`):
   weight bytes below 0.6x the bf16 model's, one down_proj's device time
   int8 against bf16, the serve phase's paged burst on the int8 model;
   then 4 fp32 int8 layers, the paged engine token-identical to the
   einsum loop. (c) GPT-2 small at full width and depth, bf16: a paged
   burst (prompts of 20-900, max_seq_len 1024; K1 and K3 at D 64, rep
   1), then fp32 parity of the paged engine with the einsum loop. (d)
   ViT-base on 8 images of 224^2: bf16 images/s with K1 once a layer,
   fp32 logits through K1 against the einsum path within VIT_ATOL; CLIP
   debug and ResNetLite in fp32 on the card against the CPU on the same
   weights; `entry()`'s forward with finite logits. Each model is freed
   before the next.
7. train: `make_train_step` with adamw and warmup_cosine on Llama-3-8B
   widths cut to 8 layers (bf16 compute, fp32 master weights, remat),
   5 steps on one fixed batch of 2 x 2048 tokens: finite losses and
   grad norms, the last loss below the first, and K1/K2a/K2b launched
   exactly as the path implies (counters zeroed just before); then one
   more step under the profiler.
8. trainer: `SpmdTrainer.fit` (a world of one: the plain step) on the
   train phase's model and optimizer (lr 1e-5), fed by
   `device_put_iterator` from fresh seeded numpy batches of 2 x 2049
   int64 tokens, Zipf over the whole vocabulary (narrowed to int32 on
   the way), 8 steps logged every step, no checkpoint: finite losses
   that fall, K1/K2a/K2b launched 2 x layers x steps and layers x
   steps, the median step (from the trainer's tokens_per_s) beside the
   train phase's, peak memory, `profiler.hbm_usage()` and
   `profiler.timed_steps` of the same step; then the same fit at the
   train phase's lr 3e-4, in bf16 and in fp32 compute, printed only.
9. trainer-resume: at the flagship widths (bf16 compute, fp32 master
   weights, adamw), a 6-step fit whose source fails drawing batch 4
   (checkpoints every 2 steps) resumes from its step-4 checkpoint with a
   fast_forward iterator: batches 1-3 are never drawn again, and every
   step's loss equals an uninterrupted 6-step run's (RESUME_RTOL; bit
   for bit expected).
10. train-parity: 3 fp32 train steps (TF32 off) of the flagship widths
   on the GPU (K1/K2a/K2b) give the CPU's loss and grad_norm, and so
   does one GPU step under remat "dots" (selective checkpointing; K1
   runs twice per layer).
11. grpo: post-training through the engine, 2 prompts a step of 64-224
   random tokens, groups of 8, 32 new tokens at temperature 1, 2 steps,
   the paged engine sampling (K1 on prefill, K3 on decode). (a)
   Full-parameter GRPO on the train phase's model (8 of 32 layers at 8B
   widths, fp32 params, bf16 compute, remat); the engine shares the
   learner's module, so its weights are the learner's after each step.
   (b) LoRA GRPO over Llama-3-8B at full depth, a frozen bf16 base and
   rank-8 adapters on the default targets; the engine's own copy holds
   merge_lora(base, adapters) after each step, bit for bit, and the base
   stays bit-identical. Each: in-vocab completions, finite stats, kl > 0
   after the first update (the reference is frozen), K1/K2a/K2b launched
   by the learner exactly as the path implies, the step's sample,
   log-prob and update times and peak memory. (c) fp32 parity at the
   flagship widths: one GRPOLearner.update, full and over LoRA adapters,
   on the GPU against the CPU (stats, gradients, updated params).
12. north-star: pretrain the flagship widths on a repeating corpus,
   checkpoint through CheckpointManager, restore, and serve the restored
   weights through LLMServer: the greedy continuation must match the
   corpus at least once in 6 tokens; then GRPO post-train the restored
   model through the engine sampler for 6 steps: the reward must not
   fall by more than 0.5 and every loss is finite.

13. parallel: on the n = torch.cuda.device_count() cards (one rank a
   card, launched by train.backend.launch; at n == 1 a world of one NCCL
   rank in this process): (a) the train phase's model and schedule at
   min(32, 8 n) layers under MeshSpec(fsdp=n) (FSDP2, fp32 master
   weights and all-gather), 2 x 2048 tokens a rank: finite losses that
   fall, K1 2 x layers x steps and K2a/K2b layers x steps on every rank,
   the median step and peak memory beside the train phase's; (b) 2 fp32
   sgd steps of the flagship widths on the mesh equal to one device's
   (loss, grad_norm and params, rtol 1e-4); (c) ring_attention at sp =
   n against multi_head_attention at Llama-3-8B attention shape, bf16
   (K1 at n == 1); (d) (b)'s model saved sharded, restored onto the mesh
   with `shardings` (each rank's memory rising by no more than its
   shards plus the largest leaf) and onto one device, both bit for bit,
   and served by the paged engine token-identical to the einsum loop;
   (e) entry.dryrun_multichip(n) on CUDA; (f) Mixtral-8x7B widths at 2
   fp32 layers on MeshSpec(ep=n): each layer's aux loss equal to one
   device's on the same global batch within 1e-5. At n == 1 (d)'s bound
   and (f) cannot fail (the shards are the tree, one data rank reduces
   nothing), and the script says so.
14. runtime: the port's runtime (`ray_tpu_torch.init()`, with the
   driver's CUDA caches emptied first and the card's free memory
   printed). (a) the cluster's GPU resource is the card count; a
   num_gpus=1 actor sees get_gpu_ids() == [0], CUDA_VISIBLE_DEVICES "0"
   and CUDA, a CPU task sees "" and no CUDA. (b) a chain of three bf16
   tensors of 64 MiB each on one GPU actor stays on the card: the
   device-store counters show 2 hits (the edges) and nothing
   materialized until the driver's get, whose copy equals the actor's
   tensor bit for bit. (c) TorchTrainer, one rank actor with
   num_gpus=1, runs the train phase's model, batch, optimizer and 5
   steps: K1 2 x layers x steps, K2a/K2b layers x steps, its losses the
   train phase's (RUNTIME_RTOL), its median step and peak memory beside
   the in-process step's, and its spawn-to-first-step time.
   (d) ElasticSpmdTrainer at world 1 on the flagship widths: the rank
   is killed once its second checkpoint is committed, the gang reforms
   once at full size after the dead process exited, restores, and every
   later loss equals an uninterrupted fit's (RUNTIME_RTOL); the reform
   time is printed; with RAY_TPU_ELASTIC_TRACE set (phase 19's (e)) the
   rank's `<path>.r0` holds its enter line for generations 0 and 1. No
   worker process is left after shutdown.
15. serve-deploy: the serve control plane on the card, in a runtime of
   its own. (a) `build_openai_deployment` of the serve phase's model
   (built in the replica from seed 0) and engine (paged, page 16, 8
   slots), one replica with its default reservation, `num_gpus=1`,
   `serve.run` and `start_proxy(port=0)`: the replica sees GPU [0],
   CUDA_VISIBLE_DEVICES "0" and an engine on CUDA; the time to a
   healthy app is printed. (b) The serve phase's 8 prompts (32 new
   tokens, one at temperature 0.8 / top_p 0.9, one streamed as SSE)
   sent at once to /v1/completions, one warm-up burst and 3 measured:
   every reply 200 with 32 in-vocab token ids (the server has no
   tokenizer: its text is the ids), the replica's K1 and K3 counters
   (read in its process through a subclass of OpenAIServer) grown, its
   engine slots free after; the medians of the client's time to the
   first SSE chunk and to the whole unary reply, decode tokens/s and
   the replica engine's TTFT and TPOT beside the serve phase's, and the
   HTTP path's overhead on lone streamed requests. (d) The replica
   killed (`serve.chaos.kill_replica`): the seconds to the first 200
   reply, the replacement again on GPU [0], the old worker gone. (c)
   The parity phase's fp32 model in a replica (TF32 off there), greedy
   over HTTP, unary and SSE, token-identical to the parity phase's
   plain loop. (e) After `serve.shutdown()` and `shutdown()` no worker
   is left and the card's free memory is within 1 GiB of the phase's
   start.
16. data: (b) the loader alone: 32 batches of ViT-base's input (64 x
   224 x 224 x 3 uint8, seed 1) through `from_numpy(...)
   .iter_device_batches(prefetch=2)`, its GB/s against a bare pinned
   host-to-card `copy_` of one batch, every batch on the card equal to
   its host rows. Then in a runtime of its own: (a) 256 text rows of
   2049 Zipf token ids (seed 0) -> `read_text` (32 rows a block) ->
   `tokenize_dataset` with a plain callable -> `random_shuffle(seed=0)`
   handed to `TorchTrainer(datasets=)` with one rank actor on the card,
   whose loop reads its shard through `prepare_loader` (batch 2) and
   trains the train phase's model (8 layers, bf16 compute, fp32
   master, remat, adamw at lr 1e-5) for 8 steps: fit() to the first
   batch on the card, the median step beside the runtime phase's
   rank-actor step, the median wait in the loader's next(), the
   executor's in-flight peak, the exchange run in the rank, K1/K2a/K2b
   counted in the rank; its rows on the card equal the same pipeline's
   rows on the driver bit for bit (int32 ids, int8 mask), its losses
   the in-process step's on those batches (RUNTIME_RTOL). (c) The
   pipeline before its shuffle (the service refuses an exchange)
   registered with `to_service(world_size=1)` and read on the card
   through the service iterator's `iter_device_batches`: the time to
   the first batch, the set of rows (a)'s, no service actor left after
   `shutdown_service`.
17. tune: in a runtime of its own, `Tuner(with_resources(trial, {"CPU":
   1, "GPU": 1}))` over lr 1e-5, 3e-5, 1e-4, 3e-4 with ASHA (mode min,
   max_t 8, grace 2, rf 2); each trial builds 2 layers of the 8B widths
   on the card (seed 0, bf16/fp32, remat, adamw) and reports the loss
   of up to 8 steps on one fixed 2 x 2048-token Zipf batch: each trial
   on GPU [0], one at a time, finding the card free; its losses the
   same lr's in-process steps' (RUNTIME_RTOL); its stop where ASHA fed
   those in-process losses on the host stops it; the best result the
   lowest last loss; no trial actor left, the card's memory back.
18. front doors: how users reach the system, through its entry points
   and processes. In a runtime of its own: (a) `start_dashboard(port=0)`
   and a num_gpus=1 actor holding 64 MiB of bf16 on its card; `python -m
   ray_tpu_torch --address URL` status, list actors and workers, summary
   tasks, metrics and timeline: the cluster's GPU 1, the actor's worker
   on gpu_ids [0], its RSS in `memory_summary()`; `python -m
   ray_tpu_torch lint` reports 0 findings. (c) A job script (a driver
   with its own `init()`: 4 steps at lr 1e-5 of the tune phase's model
   in one TorchTrainer rank on the card) sent with `job submit --remote`
   through (a)'s dashboard, read with `job logs --follow`, `job status`
   and `job list`: SUCCEEDED, its losses the tune phase's in-process
   losses at that lr (RUNTIME_RTOL), K1/K2a/K2b as the step predicts,
   the time from submit to its first step; `job stop` ends a sleeping
   CPU job. (e) PPO on GridWorld with 2 remote env runners (2 envs x 8
   steps each) and the learner on the card, 2 iterations:
   timesteps_total 32 then 64, each runner's process with
   CUDA_VISIBLE_DEVICES "", the learner's params on the card. Then (b)
   `python -m ray_tpu_torch serve run frontapp:app --port 0
   --dashboard-port 0` of an app module written to a temporary
   directory on PYTHONPATH: build_openai_deployment of the parity
   phase's fp32 model (TF32 off in the replica) with a counting server:
   the seconds from its start to the first 200 reply; over HTTP, unary
   and SSE, the parity phase's plain loop's greedy tokens; K1 and K3
   counted in the replica; `serve status` through its dashboard lists
   the app; SIGINT ends it, and a second run is ended by SIGTERM: each
   leaves no process and the card's memory comes back. (d) A client
   host (`python -m ray_tpu_torch.client.server --num-gpus 1`) and two
   client processes, one seeing the card and one with
   CUDA_VISIBLE_DEVICES="": each `init(address="ray://...")` and a
   num_gpus=1 task running 2 layers of the 8B widths in bf16 over a
   2048-token prompt (K1 counted) that returns its last row of logits as
   a CUDA tensor: on the client's card with the task's checksum, or on
   the client's CPU with the same bytes and CUDA never initialised; the
   median round trip of a small task; a named num_gpus=1 actor sees
   get_gpu_ids() == [0]; the host outlives both and leaves no process
   after SIGTERM. (f) `cluster_utils.Cluster`, the head and one agent
   (num_gpus 0): one GPU in the cluster, a num_gpus=1 task on the head's
   node, a CPU task pinned to the agent with
   NodeAffinitySchedulingStrategy there, no agent after shutdown.
19. pinned routes and the rest: (a) the parity phase's fp32 model built
   under each `attn_impl` on the paged engine: "xla" with
   RAY_TPU_PAGED_ATTN_IMPL=gather (K1 and K3 launched 0 times),
   "pallas" with the knob at "pallas" (both launched), "dpa" (K1 0) and
   "auto", each token-identical to the parity phase's plain loop; 3 fp32
   sgd steps of 2 flagship layers under "xla", "pallas" and "dpa" agree
   within PARITY_RTOL (K2a/K2b under "pallas" only); "pallas" at head
   dim 96 (the routes phase's Phi-3 widths, through the model and the
   op) and in fp16, and "dpa" with Sq != Sk, raise and launch nothing.
   (b) The crossover: one causal bf16 attention call at Llama-3-8B
   widths (B 1, Hq 32, Hkv 8, D 128) timed under "xla" (einsum),
   "pallas" (K1) and "dpa" (SDPA) at S 128, 512, 2048 and 4096, forward
   plus backward at 512 and 2048; printed only. In a runtime of its
   own: (c) a durable workflow of three num_gpus=1 steps (a 2048-token
   prompt embedded, 2 layers of the 8B widths in bf16, the last row's
   checksum): a rerun with its id runs no step and returns the same
   output; a step raising on its first attempt leaves FAILED and
   `resume` runs only that step; a process with CUDA_VISIBLE_DEVICES=""
   reads the output as a CPU tensor with the same bytes, CUDA never
   initialised. (d) Two num_gpus=0.5 actors, each holding 2 layers of
   the 8B widths in bf16, on GPU [0], their forwards at the same time
   (K1 in each); a third waits until one is killed; the GPU resource
   reads 0.0, 0.5 and 1.0; no worker left, the card's memory back. (e)
   rides the runtime phase's (d). The gRPC proxy and C++ tasks do not
   run here: the card's machine has no `grpc`, and C++ tasks do not
   touch the card.
20. parallelism, the rest: (a) the sp attention core
   (`sequence_parallel_attention`, route "pallas") at Llama-3-8B
   attention widths (B 1, Hq 32, Hkv 8, D 128, bf16, causal), an
   8192-token sequence in 4 chunks of 2048, each chunk's queries
   against the whole K/V, forward and backward with a seeded dO: the
   chunks' outputs and dQ, and their dK/dV summed, against the plain
   versions as the kernels phase holds K1 and K2 (the output within
   K1's tolerance; the gradients within K2's, the plain backward fed
   the core's lse and delta), and one K1 and one K2a/K2b call on the
   whole sequence against them the same way; K1, K2a and K2b launched
   7 times each (chunk 0 has no prefix); the chunks' time beside the
   whole call's. (b) 2 bf16 MoE
   blocks of Mixtral-8x7B widths (E 8, k 2, d 4096, ff 14336) on 4096
   tokens at capacity factor 1.0 (tokens drop): the port's index
   dispatch against the reference's one-hot (G, E, C) formulation kept
   here (`moe_onehot`) on each block's input: the same (token, slot)s
   kept, outputs within MOE_ATOL / MOE_RTOL; each one's time and peak
   memory. (c) at world n (n cards; at n == 1 a world of one NCCL rank
   in this process): 2 fp32 sgd steps of 2 flagship layers on
   MeshSpec(sp=n) equal to one device's (loss, grad_norm, params; rtol
   1e-4), K1/K2a/K2b launched on every rank; PPO on CartPole with
   use_mesh=True (MeshSpec(dp=n)), 2 iterations, its learner stats
   within 1e-5 of use_mesh=False's. At n == 1 both meshes are of one
   rank, so the step and the learner take their plain paths: the
   launches are keyed `mesh-of-one`, not `sp-mesh`, and sp's own come
   only from runs on several cards. (d) only where n >= 4: the train
   phase's model (8 layers of the 8B widths) on MeshSpec(fsdp=2, sp=2)
   at 2 x 8192 tokens (median step, peak memory a rank), GPT-2 small
   on MeshSpec(tp=4) (2 fp32 steps equal to one device's, its
   checkpoint restored onto one device bit for bit), Mixtral-8x7B
   widths at 2 fp32 layers on MeshSpec(ep=2, tp=2) (loss and each
   layer's aux loss within 1e-5 of one device's, peak memory); at n < 4
   it prints "four-card part not run".
21. the experts in FSDP2: (a) this machine's torch in one world of 4
   gloo CPU ranks, a small Mixtral (E 4, d 64, ff 128) on MeshSpec(fsdp=
   2, ep=2), (ep=2, tp=2) and (fsdp=2, tp=2), 3 fp32 sgd steps each
   equal to one device's (rtol 1e-4): every expert a DTensor in FSDP2 on
   fsdp and the axes that split it, each rank's shard the table's
   (`partition_spec_for`), whole over d when its layer's forward
   starts, the ep exchange on the ep group of the experts' mesh; (b)
   K1 and K2a/K2b against their plain versions at the Mixtral step's
   attention shape (2 x 256 tokens, Hq 32, Hkv 8, D 128, fp32, causal),
   then Mixtral-8x7B widths at 2 fp32 layers (TF32 off) in a world of
   n ranks on MeshSpec(ep=n) (at n == 1 every axis is 1: the degenerate
   mesh, the experts on (fsdp, ep) and whole) or, where n >= 4,
   MeshSpec(fsdp=2, ep=n // 2): 2 sgd steps equal to one device's
   (loss, grad_norm, params; rtol 1e-4), every rank's expert shards the
   table's, their bytes a rank beside the whole and beside the layout
   before this one (whole over d), peak memory, and K1/K2a/K2b launched
   4 times each on every rank.

Each engine of the serving phases (the bursts, the parity and route
engines, the pinned routes, GRPO's samplers and the replicas of
serve-deploy and the front doors) prints its `get_stats()
["decode_graphs"]` and its decode-graph replays ("decode graphs: ..."
lines). After the last phase a paged engine that did not capture its
graphs or never replayed them, or a contiguous one that did, fails the
run; engines in a rank's or a worker's own process print only.

The last three lines are a JSON object listing each kernel (with its
launches on each path, the zoo's bursts and ViT's forward among them,
the front doors' `cli-serve`, `job` and `client`, phase 19's
`pinned-pallas`, `pinned-xla`, `pinned-dpa`, `workflow` and
`fractional`, phase 20's `sp-chunks`, `sp-mesh` (`mesh-of-one`
on one card) and `moe-dispatch`, and phase 21's `experts-fsdp`), the
card's name
and power limit as nvidia-smi
gives them, and {"ok": true, "device": {...}}. Imports nothing of JAX
or ray_tpu.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores, and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
HOLD_CYCLES = 2_000_000     # ~1 ms of device spin at the H100's clocks

# tolerances of kernel vs plain version on the same inputs, bf16. Both
# round O to bf16 (one ulp is 2**-7 of the value at worst), and K1 also
# rounds P to bf16 before P.V as the Pallas kernel does, so K1's output
# may differ by up to two ulps: |err| <= atol + rtol * |plain|. K3 keeps
# P in fp32; the two sum in different orders in fp32.
K1_ATOL_OUT, K1_RTOL_OUT = 1e-2, 1.6e-2
K1_ATOL_LSE = 1e-3      # lse is fp32 in both
K3_ATOL = 2e-2
K1_ATOL_FP32 = 1e-4     # fp32 (out and lse): exact products, sums in
                        # another order
# (batch, sequence, causal, Hq, Hkv, D, dtype) against the plain version.
# bf16 D 64 and 128 take the wgmma kernel (128 query rows a CTA, 64-key
# tiles): causal Llama-3-8B heads at three lengths (timed; (1, 2048) is
# the shape written to the JSON), non-causal, S 1000 (ends inside a
# tile) both ways, Hq = Hkv, and the flagship's D 64 at S 32 (the
# north-star phase's shape, shorter than one tile) and S 130; the zoo's
# D 64 shapes: ViT-base's non-causal forward (8 images, S 197, 12/12
# heads) and GPT-2 small's largest prefill groups (4 x 512 and 1 x 1024,
# causal, 12/12 heads). bf16 D 32 and 16 take the mma.sync kernel, fp32
# the scalar one (the train-parity phase's head shape). Last, the GRPO
# update's batch: 16 completions (2 prompts x 8) of a ragged 287 tokens,
# Llama-3-8B heads.
K1_SHAPES = [(1, 128, True, 32, 8, 128, "bfloat16"),
             (4, 512, True, 32, 8, 128, "bfloat16"),
             (1, 2048, True, 32, 8, 128, "bfloat16"),
             (1, 1024, False, 32, 8, 128, "bfloat16"),
             (1, 1000, True, 32, 8, 128, "bfloat16"),
             (1, 1000, False, 32, 8, 128, "bfloat16"),
             (1, 512, True, 8, 8, 128, "bfloat16"),
             (4, 32, True, 8, 4, 64, "bfloat16"),
             (1, 130, True, 8, 4, 64, "bfloat16"),
             (2, 130, False, 8, 8, 64, "bfloat16"),
             (8, 197, False, 12, 12, 64, "bfloat16"),
             (4, 512, True, 12, 12, 64, "bfloat16"),
             (1, 1024, True, 12, 12, 64, "bfloat16"),
             (1, 130, True, 8, 4, 32, "bfloat16"),
             (2, 40, False, 8, 2, 16, "bfloat16"),
             (2, 256, True, 8, 4, 64, "float32"),
             (16, 287, True, 32, 8, 128, "bfloat16")]
K1_TIMED = [(1, 128), (4, 512), (1, 2048)]   # causal D 128 bf16 shapes
K1_RECORD = (1, 2048)                         # shape written to the JSON
# K2a/K2b vs their plain versions, bf16. Both round dS (and K2b P) to
# bf16 before the products that take them, as the Pallas kernels do, but
# the fp32 values being rounded come from sums in different orders, so a
# rounding may land one bf16 ulp apart; dQ sums that over up to S keys
# and dK/dV over S * Hq/Hkv query rows, and the outputs are rounded to
# bf16 again: |err| <= atol + rtol * |plain|, two output ulps plus an
# absolute floor for the near-zero entries of the sums.
K2_ATOL, K2_RTOL = 1e-2, 1.6e-2
K2_ATOL_FP32 = 1e-4     # fp32: exact products, sums in another order
# (batch, sequence, causal, Hq, Hkv, D), bf16. (2, 2048, True, 32, 8,
# 128) is the train phase's shape and the one written to the JSON. D 64
# and 128 take the wgmma kernels (128-row resident tiles, 64-row
# streamed tiles): S 32 is the north-star phase's shape (FLAGSHIP
# heads), shorter than one tile; S 130 and 1000 end inside a tile; Hq =
# Hkv has no GQA group. D 32 and 16 take the mma.sync kernels, at ragged
# S and a GQA group of 2 and 4. Last, the GRPO update's batch (16 x 287,
# Llama-3-8B heads).
K2_SHAPES = [(1, 128, True, 32, 8, 128), (4, 512, True, 32, 8, 128),
             (1, 2048, True, 32, 8, 128), (2, 2048, True, 32, 8, 128),
             (1, 1024, False, 32, 8, 128), (1, 1000, True, 32, 8, 128),
             (1, 1000, False, 32, 8, 128), (1, 512, True, 8, 8, 128),
             (4, 32, True, 8, 4, 64), (1, 130, True, 8, 4, 64),
             (2, 130, False, 8, 8, 64), (1, 130, True, 8, 4, 32),
             (2, 40, False, 8, 2, 16), (16, 287, True, 32, 8, 128)]
K2_RECORD = (2, 2048, True, 32, 8, 128)
# fp32 at the train-parity phase's head shape (Hq 8, Hkv 4, D 64)
K2_FP32_SHAPES = [(2, 256, True), (1, 300, False)]
# K3's timed shape (written to the JSON): 8 sequences of Llama-3-8B heads,
# page 16, a 2048-key table, bf16
K3_LENGTHS = [1, 37, 250, 512, 900, 1333, 1700, 2000]
K3_EARLY_QPOS = (3, 100)                      # (row, qpos < lengths - 1)
K3_ATOL_FP32 = 1e-4     # fp32: exact products, sums in another order
# K3 against its plain version at the edges of its splits (256 keys, or
# the most whole pages that fit): (label, Hq, Hkv, D, page size, table
# keys, dtype, lengths, {row: early qpos}). Lengths of exactly one split,
# one past it, one short of a page, 0 beside full rows and the table's
# whole width; rep 1 and 16 (MAX_REP); D 64; page 8; a table of one split
# (the kernel writes O itself, no merge); a table whose last split is
# short (63 pages of 16); page 48 (splits of 240 keys); fp32 (the parity
# phase's heads); GPT-2 small's decode (12/12 heads, rep 1, D 64, page
# 16, its 1024-key table).
K3_CASES = [
    ("split edges", 32, 8, 128, 16, 2048, "bfloat16",
     [256, 257, 255, 0, 2048, 47, 1, 512], {7: 300}),
    ("rep 1", 8, 8, 128, 16, 2048, "bfloat16", [300, 0, 2048, 17], {}),
    ("rep 16", 32, 2, 128, 16, 2048, "bfloat16", [1000, 256, 0, 2048],
     {0: 500}),
    ("D 64", 8, 4, 64, 16, 2048, "bfloat16", [513, 0, 2048, 64], {}),
    ("page 8", 32, 8, 128, 8, 2048, "bfloat16", [256, 257, 7, 2048, 0], {}),
    ("one split", 32, 8, 128, 16, 256, "bfloat16", [256, 0, 100, 17], {}),
    ("short last split", 32, 8, 128, 16, 1008, "bfloat16",
     [1008, 1000, 769, 0], {}),
    ("page 48", 32, 8, 128, 48, 1008, "bfloat16", [1008, 240, 241, 0, 500],
     {}),
    ("fp32", 32, 8, 128, 16, 2048, "float32", [256, 257, 0, 2048, 1000],
     {4: 10}),
    ("GPT-2 small", 12, 12, 64, 16, 1024, "bfloat16",
     [1024, 921, 257, 256, 0, 20, 500, 1023], {}),
]
# K4 vs rms_norm_plain: (x shape, x type, weight type). fp32 sums in
# another order: atol = rtol = 1e-5. bf16 and fp16: both round y once
# from fp32 values a few fp32 ulps apart, so they may land one ulp apart:
# |err| <= atol + rtol * |plain|. Whole 16-byte-vector rows take the
# ring route (rows streamed through shared memory by bulk copies): one
# row, 8 rows of 4096 (a decode step's norm), 5005 rows (a block a warp,
# no multiple of a CTA's warps), rows of 1 KB several to a stage with a
# short last stage (4101 fp32 rows of 256, 4099 bf16 rows of 512),
# bf16, fp16 and fp32 weights (a bf16 weight of 1004 values is no whole
# number of 16-byte vectors: staged by scalar loads), fp32 at d = 4096
# (16 KB rows); an fp32
# row of 20480 is too wide for the ring (weight and two stages past a
# CTA's shared memory) and takes the two-pass vector loop; a row of d =
# 1001 is no whole number of 16-byte vectors in either type and takes
# the scalar loads.
K4_SHAPES = [((4, 33, 256), "float32", "float32"),
             ((4, 1024, 512), "bfloat16", "bfloat16"),
             ((2, 2048, 4096), "bfloat16", "float32"),
             ((1, 4096), "bfloat16", "float32"),
             ((8, 4096), "bfloat16", "float32"),
             ((5, 1001, 4096), "bfloat16", "float32"),
             ((3, 1367, 256), "float32", "float32"),
             ((4099, 512), "bfloat16", "bfloat16"),
             ((2, 64, 4096), "bfloat16", "bfloat16"),
             ((2, 64, 4096), "bfloat16", "float16"),
             ((4, 16, 2048), "float16", "float16"),
             ((3, 7, 1000), "float32", "float32"),
             ((3, 7, 1004), "float32", "bfloat16"),
             ((2, 64, 4096), "float32", "float32"),
             ((3, 5, 20480), "float32", "float32"),
             ((4, 16, 512), "float16", "float32"),
             ((3, 7, 1001), "float32", "float32"),
             ((3, 7, 1001), "bfloat16", "float32")]
K4_RECORD = ((2, 2048, 4096), "bfloat16", "float32")
K4_DECODE = ((8, 4096), "bfloat16", "float32")   # timed beside the record
K4_TOL_FP32 = 1e-5
K4_ATOL_BF16, K4_RTOL_BF16 = 1e-2, 8e-3
K4_GRAD_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# (label, get_stats()["decode_graphs"], replays, paged) of each engine a
# phase ran in this process or in its replica; main() checks them at
# the end, so one run names every engine whose decode was not graphed
GRAPHS: list = []


def graph_replays() -> int:
    """Decode-graph replays made in this process so far."""
    from ray_tpu_torch.models.decode_graph import DecodeGraphs
    return DecodeGraphs.replay.launches


def note_graphs(label: str, state: str, replays: int,
                paged: bool = True) -> None:
    GRAPHS.append((label, state, replays, paged))
    print(f"decode graphs: {label}: {state}, {replays} replays", flush=True)


def check_graphs() -> None:
    """Every paged engine on the card captured its decode graphs and
    replayed them; every contiguous one stayed eager."""
    bad = [g for g in GRAPHS if (g[1], g[2] > 0)
           != (("captured", True) if g[3] else ("off", False))]
    print(f"decode graphs: {len(GRAPHS) - len(bad)} of {len(GRAPHS)} "
          f"engines as expected: " + json.dumps(
              {label: [state, n] for label, state, n, _ in GRAPHS}),
          flush=True)
    check(not bad, f"decode graphs: not as expected: {bad}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, each launch timed alone by CUDA
    events after the 50 MB L2 cache was overwritten (the main path
    finds a layer's inputs cold). A device-side spin holds the stream
    before the start event, so the host has issued the whole call before
    the device reaches it: the events time the device work, not the
    host's Python between them."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch):
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.ops.kernels import rmsnorm as rn
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [k1_row(torch, gen), k3_row(torch, gen)]
    rows += k2_rows(torch, gen)
    rows.append(k4_rows(torch, gen))
    print("kernels: launches in this phase " + json.dumps(
        {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
         "paged_decode (K3)": pa.paged_decode_attention.launches,
         "flash_bwd_dq (K2a)": fa.flash_bwd_dq.launches,
         "flash_bwd_dkv (K2b)": fa.flash_bwd_dkv.launches,
         "rmsnorm (K4)": rn.rmsnorm_fwd.launches}), flush=True)
    return rows


def k1_check(torch, gen, b, s, causal, hq, hkv, d, dt_name):
    """K1 once against flash_attention_plain on seeded inputs; returns
    the inputs, the label and the output's largest error."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    dt = getattr(torch, dt_name)
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if dt == torch.float32:
        tol = f"atol {K1_ATOL_FP32}"
        ok = err <= K1_ATOL_FP32 and lse_err <= K1_ATOL_FP32
    else:
        tol = (f"out atol {K1_ATOL_OUT} + rtol {K1_RTOL_OUT}, lse atol "
               f"{K1_ATOL_LSE}")
        ok = bool((diff <= K1_ATOL_OUT
                   + K1_RTOL_OUT * ref.float().abs()).all()) \
            and lse_err <= K1_ATOL_LSE
    route = ("fp32 scalar" if dt == torch.float32 else
             "wgmma" if d >= 64 else "mma.sync")
    label = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} {dt_name} "
             f"{'causal' if causal else 'non-causal'}")
    print(f"kernels: K1 flash_fwd {label} ({route}) max_abs_err out="
          f"{err:.3g} lse={lse_err:.3g} ({tol}: {ok})", flush=True)
    check(ok, f"K1 disagrees with its plain version at {label}")
    return (q, k, v), label, err


def k1_row(torch, gen):
    """K1 against flash_attention_plain at K1_SHAPES; two launches of the
    wgmma kernel compared bit for bit; times at K1_TIMED."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    k1_err, rec = 0.0, None
    for b, s, causal, hq, hkv, d, dt_name in K1_SHAPES:
        dt = getattr(torch, dt_name)
        (q, k, v), label, err = k1_check(torch, gen, b, s, causal, hq, hkv,
                                         d, dt_name)
        k1_err = max(k1_err, err)
        if not (causal and d == 128 and hq == 32 and dt == torch.bfloat16
                and (b, s) in K1_TIMED):
            continue
        if (b, s) == K1_RECORD:
            # no atomics: two launches on the same inputs give the same bits
            runs = [fa.flash_attention_fwd(q, k, v, causal=True)
                    for _ in range(2)]
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            print(f"kernels: K1 {label} two launches bit-identical (out, "
                  f"lse): {same}", flush=True)
            check(same, "K1 gave different bits on the same inputs")
            del runs
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        flops = 4.0 * b * hq * d * (s * (s + 1) / 2)
        nbytes = 2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d) \
            + 4.0 * b * hq * s
        bms, by = bound_ms(flops, nbytes)
        print(f"kernels: K1 B={b} S={s} kernel {ms:.4f} ms "
              f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain "
              f"{plain:.4f} ms, library (sdpa) {lib:.4f} ms "
              f"({flops / (lib * 1e-3) / 1e12:.1f} TFLOP/s), bound "
              f"{bms:.4f} ms ({by})", flush=True)
        if (b, s) == K1_RECORD:
            rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=lib, shape=label)
        del qt, kt, vt
    return dict(name="flash_fwd (K1)", route="cuda",
                source="ray_tpu_torch/csrc/flash_fwd.cu",
                replaces="ray_tpu/ops/pallas/flash_attention.py:36",
                max_abs_err=k1_err, **rec)


def k3_inputs(torch, gen, hq, hkv, d, ps, table_keys, dt, lengths, early):
    """Random page pools, a shuffled page table of table_keys keys per
    sequence (one spare page), q, lengths and qpos (lengths - 1, except
    the rows of `early`)."""
    n = len(lengths)
    per_seq = -(-table_keys // ps)
    n_pages = n * per_seq
    k_flat = torch.randn((n_pages + 1) * ps, hkv, d, device="cuda",
                         generator=gen).to(dt)
    v_flat = torch.randn((n_pages + 1) * ps, hkv, d, device="cuda",
                         generator=gen).to(dt)
    table = torch.randperm(n_pages, device="cuda", generator=gen) \
        .reshape(n, per_seq).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qpos = lens - 1
    for row, qp in early.items():
        qpos[row] = qp
    q = torch.randn(n, hq, d, device="cuda", generator=gen).to(dt)
    return q, k_flat, v_flat, table, lens, qpos


def k3_row(torch, gen):
    """K3 against paged_decode_attention_plain at K3_CASES and at its
    timed shape (K3_LENGTHS), with its times there."""
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    err_max = 0.0
    cases = [("timed", 32, 8, 128, 16, 2048, "bfloat16", K3_LENGTHS,
              dict([K3_EARLY_QPOS]))] + K3_CASES
    for label, hq, hkv, d, ps, keys, dt_name, lengths, early in cases:
        dt = getattr(torch, dt_name)
        args = k3_inputs(torch, gen, hq, hkv, d, ps, keys, dt, lengths,
                         early)
        q, k_flat, v_flat, table, lens, qpos = args
        out = pa.paged_decode_attention(q, k_flat, v_flat, table, lens, ps,
                                        qpos=qpos)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_plain(q, k_flat, v_flat, table, lens,
                                              ps, qpos=qpos)
        err = (out.float() - ref.float()).abs().max().item()
        atol = K3_ATOL_FP32 if dt == torch.float32 else K3_ATOL
        split_keys, n_split = pa.split_plan(table.shape[1], ps)
        print(f"kernels: K3 paged_decode {label}: Hq={hq} Hkv={hkv} D={d} "
              f"page_size={ps} {dt_name} lengths={lengths} qpos "
              f"{early or 'lengths - 1'} splits {n_split} x {split_keys} "
              f"keys, max_abs_err={err:.3g} (atol {atol}: {err <= atol})",
              flush=True)
        check(out.shape == ref.shape and err <= atol,
              f"K3 disagrees with its plain version ({label})")
        err_max = max(err_max, err)
        if label != "timed":
            continue
        ms = time_ms(lambda: pa.paged_decode_attention(
            q, k_flat, v_flat, table, lens, ps, qpos=qpos))
        plain = time_ms(lambda: pa.paged_decode_attention_plain(
            q, k_flat, v_flat, table, lens, ps, qpos=qpos))
        bounds = [min(ln, qp + 1) for ln, qp in zip(lengths, qpos.tolist())]
        keys_read = sum(bounds)
        flops = 4.0 * hq * d * keys_read
        nbytes = (2.0 * keys_read * hkv * d * 2        # K and V rows read
                  + 2.0 * 2 * len(lengths) * hq * d     # q in, out
                  + 4.0 * sum(-(-b // ps) for b in bounds)   # page ids
                  + 4.0 * 2 * len(lengths))             # lengths, qpos
        bms, by = bound_ms(flops, nbytes)
        print(f"kernels: K3 kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library none, bound {bms:.4f} ms ({by})", flush=True)
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=None,
                   shape=f"S={len(lengths)} Hq={hq} Hkv={hkv} D={d} "
                   f"page_size={ps} bf16 keys={keys_read}")
    return dict(name="paged_decode (K3)", route="cuda",
                source="ray_tpu_torch/csrc/paged_decode.cu",
                replaces="ray_tpu/ops/pallas/paged_attention.py:47",
                max_abs_err=err_max, **rec)


def k2_check(torch, gen, b, s, causal, hq, hkv, d, dt):
    """K2a/K2b once against their plain versions; returns the inputs and
    (dq, dk, dv) errors."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    do = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                            causal=causal)
    errs, ok = [], True
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        diff = (got.float() - ref.float()).abs()
        errs.append(diff.max().item())
        if dt == torch.float32:
            ok = ok and errs[-1] <= K2_ATOL_FP32
        else:
            ok = ok and bool((diff <= K2_ATOL + K2_RTOL
                              * ref.float().abs()).all())
    tol = (f"atol {K2_ATOL_FP32}" if dt == torch.float32 else
           f"atol {K2_ATOL} + rtol {K2_RTOL}")
    print(f"kernels: K2 flash_bwd B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
          f"{str(dt)[6:]} {'causal' if causal else 'non-causal'} "
          f"max_abs_err dq={errs[0]:.3g} dk={errs[1]:.3g} dv={errs[2]:.3g} "
          f"({tol}: {ok})", flush=True)
    check(ok, f"K2a/K2b disagree with their plain versions at B={b} S={s} "
              f"causal={causal} {dt}")
    return (q, k, v, do, lse, delta), errs


def k2_rows(torch, gen):
    import torch.nn.functional as F
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    for b, s, causal in K2_FP32_SHAPES:
        k2_check(torch, gen, b, s, causal, 8, 4, 64, torch.float32)
    err_dq = err_dkv = 0.0
    rec = {}
    for b, s, causal, hq, hkv, d in K2_SHAPES:
        (q, k, v, do, lse, delta), errs = k2_check(
            torch, gen, b, s, causal, hq, hkv, d, torch.bfloat16)
        err_dq = max(err_dq, errs[0])
        err_dkv = max(err_dkv, errs[1], errs[2])
        if (b, s, causal, hq, hkv, d) != K2_RECORD:
            continue
        kw = dict(causal=causal)
        # determinism: no atomics, so two launches on the same inputs give
        # the same bits
        runs = [(fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
                for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        print(f"kernels: K2a/K2b B={b} S={s} two launches bit-identical "
              f"(dq, dk, dv): {same}", flush=True)
        check(same, "K2a/K2b gave different bits on the same inputs")
        del runs
        ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                **kw))
        ms_dkv = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw))
        plain_dq = time_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, **kw), iters=5)
        plain_dkv = time_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, **kw), iters=5)
        # the whole backward as _FlashAttention runs it: delta, K2a, K2b
        out, _ = fa.flash_attention_fwd(q, k, v, **kw)
        ms_bwd = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                        do, **kw))
        # library: SDPA's backward on the same inputs through autograd on
        # a retained graph. It computes dQ, dK and dV in one pass (its own
        # delta included), and no PyTorch call computes dQ or (dK, dV)
        # alone, so both rows carry this one time: compare it with K2a +
        # K2b, and with the whole backward.
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), dot, retain_graph=True))
        pairs = s * (s + 1) / 2 if causal else float(s * s)
        prod = 2.0 * b * hq * d * pairs         # one product's operations
        n_q = float(b * s * hq * d)             # elements of q, dO or dQ
        n_kv = float(b * s * hkv * d)           # elements of k, v, dK, dV
        stats = 4.0 * 2 * b * hq * s            # lse + delta, fp32
        # K2a reads q, k, v, dO, lse, delta and writes dQ; K2b reads the
        # same and writes dK, dV (bf16: 2 bytes an element)
        bq, byq = bound_ms(3 * prod, 2 * (3 * n_q + 2 * n_kv) + stats)
        bkv, bykv = bound_ms(4 * prod, 2 * (2 * n_q + 4 * n_kv) + stats)

        def tflops(n_prod, ms):
            return n_prod * prod / (ms * 1e-3) / 1e12
        print(f"kernels: K2a dq B={b} S={s} kernel {ms_dq:.4f} ms "
              f"({tflops(3, ms_dq):.1f} TFLOP/s, 3 products), plain "
              f"{plain_dq:.4f} ms, bound {bq:.4f} ms ({byq})", flush=True)
        print(f"kernels: K2b dkv B={b} S={s} kernel {ms_dkv:.4f} ms "
              f"({tflops(4, ms_dkv):.1f} TFLOP/s, 4 products), plain "
              f"{plain_dkv:.4f} ms, bound {bkv:.4f} ms ({bykv})",
              flush=True)
        print(f"kernels: K2a + K2b {ms_dq + ms_dkv:.4f} ms; the whole "
              f"backward (attention_delta + K2a + K2b) {ms_bwd:.4f} ms; "
              f"the library (sdpa backward: dq, dk and dv in one call) "
              f"{lib:.4f} ms ({tflops(5, lib):.1f} TFLOP/s, 5 products)",
              flush=True)
        if causal:
            # causal imbalance: a 64-row warpgroup skips the 64 x 64 blocks
            # wholly above the diagonal, so with n = S / 64 it computes
            # (n + 1) / 2n of the non-causal blocks; a balanced grid would
            # take that share of the non-causal time
            o_nc, l_nc = fa.flash_attention_fwd(q, k, v, causal=False)
            d_nc = fa.attention_delta(o_nc, do)
            nc_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, l_nc, d_nc,
                                                    causal=False))
            nc_dkv = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, l_nc,
                                                      d_nc, causal=False))
            n = -(-s // 64)
            print(f"kernels: K2 causal / non-causal time B={b} S={s}: K2a "
                  f"{ms_dq / nc_dq:.4f} ({nc_dq:.4f} ms non-causal), K2b "
                  f"{ms_dkv / nc_dkv:.4f} ({nc_dkv:.4f} ms); share of "
                  f"64 x 64 blocks computed {(n + 1) / (2 * n):.4f}",
                  flush=True)
            del o_nc, l_nc, d_nc
        shape = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 "
                 f"{'causal' if causal else 'non-causal'}")
        lib_note = ("SDPA's whole backward (dQ, dK, dV in one call), "
                    "to compare with K2a + K2b")
        extra = dict(library=lib_note, shape=shape, whole_bwd_ms=ms_bwd)
        rec = {"dq": dict(ms=ms_dq, plain_ms=plain_dq, bound_ms=bq,
                          bound_by=byq, library_ms=lib,
                          tflops=tflops(3, ms_dq), **extra),
               "dkv": dict(ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bkv,
                           bound_by=bykv, library_ms=lib,
                           tflops=tflops(4, ms_dkv), **extra)}
        del qt, kt, vt, out_t, dot, out
    src = "ray_tpu_torch/csrc/flash_bwd.cu"
    return [dict(name="flash_bwd_dq (K2a)", route="cuda", source=src,
                 replaces="ray_tpu/ops/pallas/flash_attention.py:175",
                 max_abs_err=err_dq, **rec["dq"]),
            dict(name="flash_bwd_dkv (K2b)", route="cuda", source=src,
                 replaces="ray_tpu/ops/pallas/flash_attention.py:207",
                 max_abs_err=err_dkv, **rec["dkv"])]


def k4_times(torch, rn, x, w):
    """K4, its plain version and F.rms_norm on x, w, with the bound."""
    import torch.nn.functional as F
    ms = time_ms(lambda: rn.fused_rms_norm(x, w))
    plain = time_ms(lambda: rn.rms_norm_plain(x, w))
    # F.rms_norm wants the weight in x's type (bf16 here)
    wx = w.to(x.dtype)
    lib = time_ms(lambda: F.rms_norm(x, (x.shape[-1],), wx, 1e-6))
    n = x.numel()
    # x read once, y written once, the weight read once; per element a
    # square-add, a product by the row's scale and one by w
    bms, by = bound_ms(4.0 * n, n * 2 * x.element_size()
                       + w.numel() * w.element_size(), PEAK_FP32_FLOPS)
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib)


def k4_rows(torch, gen):
    """K4 against rms_norm_plain at K4_SHAPES, its backward against
    plain autograd, and its times at K4_RECORD and K4_DECODE."""
    from ray_tpu_torch.ops.kernels import rmsnorm as rn
    err_max, timed = 0.0, {}
    for shape, xt, wt in K4_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen).to(
            getattr(torch, xt))
        w = torch.randn(shape[-1], device="cuda", generator=gen).to(
            getattr(torch, wt))
        y = rn.fused_rms_norm(x, w)
        torch.cuda.synchronize()
        ref = rn.rms_norm_plain(x, w)
        diff = (y.float() - ref.float()).abs()
        if x.dtype == torch.float32:
            tol = f"atol {K4_TOL_FP32} + rtol {K4_TOL_FP32}"
            ok = bool((diff <= K4_TOL_FP32
                       + K4_TOL_FP32 * ref.float().abs()).all())
        else:
            tol = f"atol {K4_ATOL_BF16} + rtol {K4_RTOL_BF16}"
            ok = bool((diff <= K4_ATOL_BF16
                       + K4_RTOL_BF16 * ref.float().abs()).all())
        err = diff.max().item()
        print(f"kernels: K4 rmsnorm x{shape} {xt} weight {wt} max_abs_err "
              f"{err:.3g} ({tol}: {ok})", flush=True)
        check(ok and y.dtype == x.dtype and y.shape == x.shape,
              f"K4 disagrees with its plain version at {shape} {xt}")
        err_max = max(err_max, err)
        if (shape, xt, wt) in (K4_RECORD, K4_DECODE):
            t = k4_times(torch, rn, x, w)
            print(f"kernels: K4 x{shape} {xt} weight {wt} kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                  f"(F.rms_norm, bf16 weight) {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound",
                  flush=True)
            timed[(shape, xt, wt)] = dict(t, shape=f"x {shape} {xt}, "
                                                   f"weight {wt}")
        del x, w, y, ref
    # the backward: autograd through the plain math, as the reference
    x = torch.randn(8, 64, device="cuda", generator=gen, requires_grad=True)
    w = torch.randn(64, device="cuda", generator=gen, requires_grad=True)
    got = torch.autograd.grad((rn.fused_rms_norm(x, w) ** 2).sum(), (x, w))
    want = torch.autograd.grad((rn.rms_norm_plain(x, w) ** 2).sum(), (x, w))
    ok = all(torch.allclose(a, b, atol=K4_GRAD_TOL, rtol=K4_GRAD_TOL)
             for a, b in zip(got, want))
    gerr = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"kernels: K4 backward (8, 64) fp32 against plain autograd: max "
          f"abs err {gerr:.3g} (atol {K4_GRAD_TOL} + rtol {K4_GRAD_TOL}: "
          f"{ok})", flush=True)
    check(ok, "fused_rms_norm's gradient differs from plain autograd")
    return dict(name="rmsnorm (K4)", route="cuda",
                source="ray_tpu_torch/csrc/rmsnorm.cu",
                replaces="ray_tpu/ops/pallas/rmsnorm.py:25",
                max_abs_err=err_max, **timed[K4_RECORD],
                library="F.rms_norm with the weight cast to bf16 (it "
                        "takes no fp32 weight with a bf16 x)",
                decode_shape=timed[K4_DECODE])


def burst(server, bodies):
    """Send every body at once (one thread each); return the token lists
    in order. Fails if any request fails or does not finish."""
    results = [None] * len(bodies)
    errors = []

    def run(i):
        try:
            if bodies[i].get("stream"):
                results[i] = list(server(bodies[i]))
            else:
                results[i] = server(bodies[i])["tokens"]
        except Exception as e:  # noqa: BLE001  reported below, then fails
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors, f"requests failed: {errors}")
    check(all(not t.is_alive() for t in threads), "requests did not finish")
    return results


# kernel name fragments -> kind, first match wins
PROFILE_KINDS = (
    ("attention kernels (K1/K2/K3)", ("flash_fwd", "bwd_dq", "bwd_dkv",
                                      "paged_decode")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("fused optimizer", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "index")),
    ("reduction", ("reduce_kernel", "softmax", "norm_kernel",
                   "cross_entropy", "nll_loss")),
)


def gpu_profile(torch, fn, label, gpu_line, top=8):
    """Run fn once under torch.profiler: the share of the wall time the
    GPU spent in kernels, and the kernels that took most of it. The
    profiler's own host cost lengthens the wall time, so the busy share
    it shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name, ranges = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # ranges (e.g. Optimizer.step) span kernels; they are not busy
        # time of their own
        into = ranges if e.is_user_annotation else by_name
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no kernel on the GPU")
    print(f"{label}: wall {wall_us / 1e3:.1f} ms, GPU busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%, a lower "
          f"bound) [{gpu_line}]", flush=True)
    kinds = {}
    for name, us in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS if any(
            key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    print(f"{label}: by kind " + ", ".join(
        f"{k} {us / 1e3:.2f} ms ({100 * us / busy_us:.1f}%)"
        for k, us in sorted(kinds.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, us in ranges.items():
        print(f"{label}: range {name} {us / 1e3:.2f} ms on the GPU "
              f"timeline", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{label}: {us / 1e3:9.2f} ms {100 * us / busy_us:5.1f}% "
              f"of busy  {name[:90]}", flush=True)


SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
SERVE_PLENS = [20, 30, 100, 200, 400, 700, 1000, 1500]
SERVE_NEW = 32                      # new tokens per request
PREFIX_LEN = 1000                   # burst (iii): shared prefix ...
SUFFIX_LENS = [20, 40, 60, 80, 100, 130, 160, 200]   # ... and suffixes
# burst (ii): chunked prefill of 512 under three decode configurations
CHUNKED_VARIANTS = [
    ("serve-chunked-block1", dict(decode_block=1)),
    ("serve-chunked", dict(decode_block=4)),
    ("serve-chunked-block4-depth3", dict(decode_block=4, pipeline_depth=3)),
]


def serve_burst(torch, server, bodies, label, gpu_line, vocab):
    """`timed_burst` of LLMServer bodies: one short sampled request
    first, then every body at once."""
    def warm():
        return server({"prompt": bodies[0]["prompt"][:8], "max_tokens": 2,
                       "temperature": 0.8, "top_p": 0.9})["tokens"]
    return timed_burst(torch, server.engine, warm,
                       lambda: burst(server, bodies),
                       [len(b["prompt"]) for b in bodies], label, gpu_line,
                       vocab)


def run_jobs(engine, jobs):
    """Submit every (prompt, submit kwargs) job to the engine at once and
    stream each on its own thread; fails if any fails or does not
    finish. Returns the token lists in order."""
    results = [None] * len(jobs)
    errors = []
    rids = [engine.submit(p, **kw) for p, kw in jobs]

    def run(i):
        try:
            results[i] = list(engine.stream(rids[i]))
        except Exception as e:  # noqa: BLE001  reported below, then fails
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors, f"requests failed: {errors}")
    check(all(not t.is_alive() for t in threads), "requests did not finish")
    return results


def engine_burst(torch, engine, jobs, label, gpu_line, vocab):
    """`timed_burst` of engine jobs (submit kwargs the server's body does
    not carry: guided FSMs, penalties)."""
    def warm():
        return engine.generate_sync(jobs[0][0][:8], max_new_tokens=2,
                                    temperature=0.8, top_p=0.9)
    return timed_burst(torch, engine, warm, lambda: run_jobs(engine, jobs),
                       [len(p) for p, _ in jobs], label, gpu_line, vocab)


def timed_burst(torch, engine, warm, run, plens, label, gpu_line, vocab):
    """One short sampled request first (`warm`: the burst's TTFT then
    leaves out first-use costs: cuBLAS handles, pinned memory, sampling
    kernels), then the burst (`run`). The K1/K3 counters are zeroed just
    before and read just after. Each request must return SERVE_NEW
    in-vocab tokens. Returns (stats, launches); stats carries the
    burst's decode tokens/s, verify steps and accepted proposals."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.models.decode_graph import DecodeGraphs
    fa.flash_attention_fwd.launches = 0
    pa.paged_decode_attention.launches = 0
    DecodeGraphs.replay.launches = 0
    check(len(warm()) == 2, f"{label}: warm-up request failed")
    engine._timings.clear()
    engine._tpot_samples.clear()
    before = engine.get_stats()
    t_start = time.time()
    results = run()
    t_end = time.time()
    launches = {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
                "paged_decode (K3)": pa.paged_decode_attention.launches}
    stats = engine.get_stats()
    note_graphs(label, stats["decode_graphs"], graph_replays(),
                paged=bool(engine.cfg.kv_page_size))
    for i, toks in enumerate(results):
        check(toks is not None and len(toks) == SERVE_NEW,
              f"{label}: request {i} returned "
              f"{None if toks is None else len(toks)} tokens, want "
              f"{SERVE_NEW}")
        check(all(0 <= t < vocab for t in toks),
              f"{label}: request {i} has out-of-vocab tokens")
    ttft = stats["ttft_breakdown_p50_ms"]["total_ms"]
    n_tok = sum(len(t) for t in results)
    stats["decode_tok_s"] = (n_tok - len(results)) / (t_end - t_start)
    for key in ("decode_steps", "spec_steps", "spec_accepted"):
        stats["burst_" + key] = stats[key] - before[key]
    print(f"{label}: {len(results)} requests x {SERVE_NEW} tokens, prompts "
          f"{plens}, wall {t_end - t_start:.3f} s, TTFT p50 {ttft} ms "
          f"(engine), decode tokens/s {stats['decode_tok_s']:.1f} (tokens "
          f"after each first token / wall), TPOT p50 "
          f"{stats.get('tpot_p50_ms')} ms, decode steps "
          f"{stats['burst_decode_steps']} (the burst's), launches "
          f"{json.dumps(launches)} [{gpu_line}; one burst]", flush=True)
    return stats, launches


def close_server(torch, server):
    server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()


# (v): the first request's TTFT on fresh engines, with and without
# precompile, under the configuration with the most paths to warm
PRECOMPILE_CONFIG = dict(kv_page_size=16, prefill_chunk=512, max_prefixes=2)
# (iv): repetitive prompts, a 16-token segment repeated
SPEC_PLENS = [64, 96, 128, 160, 192, 256, 320, 400]


def first_ttft_ms(engine, prompt):
    """Host time from submit to the first token of one request of 4."""
    t0 = time.time()
    it = engine.stream(engine.submit(prompt, max_new_tokens=4))
    next(it)
    ttft = (time.time() - t0) * 1000
    check(len(list(it)) == 3, "precompile: a request did not finish")
    return ttft


def precompile_probe(torch, model, base, prompt, gpu_line):
    """(v) Fresh paged engines on the 8B model: the first request's TTFT
    without precompile (the first engine of the process on this model),
    then with precompile() (its wall time printed), then without it
    again (the process warm)."""
    from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
    results = []
    for label, pre in (("first engine, no precompile", False),
                       ("precompile", True),
                       ("again, no precompile", False)):
        engine = LLMEngine(model, None, LLMEngineConfig(
            **base, **PRECOMPILE_CONFIG), device="cuda")
        try:
            pre_s = None
            if pre:
                t0 = time.time()
                engine.precompile()
                torch.cuda.synchronize()
                pre_s = time.time() - t0
                st = engine.get_stats()
                check(st["free_slots"] == base["max_slots"]
                      and st["prefix_tokens_saved"] == 0
                      and st["kv_pages"]["free"] == st["kv_pages"]["total"],
                      f"precompile left the engine busy: {st}")
            ttft = first_ttft_ms(engine, prompt)
        finally:
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        results.append((label, pre_s, ttft))
        print(f"serve-precompile: {label}: "
              f"{'' if pre_s is None else f'precompile() {pre_s:.3f} s, '}"
              f"first request ({len(prompt)}-token prompt) TTFT "
              f"{ttft:.1f} ms [{gpu_line}; one request]", flush=True)
    return results


def serve_controls(torch, model, base, rng, gpu_line):
    """(iv) serve-spec: greedy repetitive prompts on the paged cache,
    plain and with ngram_speculation=4 (acceptance only reported: bf16
    rounds a (K+1)-row product otherwise than a 1-row one); then a guided
    burst (choices of SERVE_NEW token ids) and a penalised one (presence,
    frequency, logit_bias), which step synchronously and pipelined.
    Returns each burst's launches."""
    import numpy as np
    from ray_tpu_torch.serve.llm import (LLMEngine, LLMEngineConfig,
                                         LLMServer, TokenFSM)
    V = model.cfg.vocab_size
    launches = {}
    prompts = [np.tile(rng.randint(0, V, 16), n // 16).tolist()
               for n in SPEC_PLENS]
    bodies = [{"prompt": p, "max_tokens": SERVE_NEW} for p in prompts]
    stats = {}
    for label, kw in (("serve-spec-plain", {}),
                      ("serve-spec", dict(ngram_speculation=SPEC_K))):
        server = LLMServer(lambda: (model, None), engine_config={
            **base, "kv_page_size": 16, **kw}, device="cuda")
        stats[label], launches[label] = serve_burst(
            torch, server, bodies, label, gpu_line, V)
        close_server(torch, server)
    st, plain = stats["serve-spec"], stats["serve-spec-plain"]
    steps = st["burst_spec_steps"]
    print(f"serve-spec: verify steps {steps}, accepted proposals "
          f"{st['burst_spec_accepted']} "
          f"({st['burst_spec_accepted'] / max(steps, 1):.3f} accepted tokens "
          f"a verify step, summed over its {len(bodies)} requests at most), "
          f"decode dispatches {st['burst_decode_steps']}; "
          f"TTFT p50 {st['ttft_breakdown_p50_ms']['total_ms']} ms, TPOT p50 "
          f"{st.get('tpot_p50_ms')} ms, decode tokens/s "
          f"{st['decode_tok_s']:.1f} beside the plain paged burst on the "
          f"same prompts: TTFT p50 {plain['ttft_breakdown_p50_ms']['total_ms']}"
          f" ms, TPOT p50 {plain.get('tpot_p50_ms')} ms, decode tokens/s "
          f"{plain['decode_tok_s']:.1f} [{gpu_line}; one burst each]",
          flush=True)

    plens = SERVE_PLENS
    guided = []
    for n in plens:
        seqs = [rng.randint(0, V, SERVE_NEW).tolist() for _ in range(2)]
        guided.append((rng.randint(0, V, n).tolist(), dict(
            max_new_tokens=SERVE_NEW, guided_fsm=TokenFSM.from_choices(
                seqs, vocab_size=V, eos_id=CONTROLS_EOS))))
    penalised = [(rng.randint(0, V, n).tolist(), dict(
        max_new_tokens=SERVE_NEW, presence_penalty=0.5,
        frequency_penalty=0.3,
        logit_bias={int(t): 1.0 for t in rng.randint(0, V, 4)}))
        for n in plens]
    for label, jobs in (("serve-guided", guided),
                        ("serve-penalised", penalised)):
        engine = LLMEngine(model, None, LLMEngineConfig(
            **base, kv_page_size=16), device="cuda")
        try:
            _, launches[label] = engine_burst(torch, engine, jobs, label,
                                              gpu_line, V)
        finally:
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        check(launches[label]["paged_decode (K3)"] > 0,
              f"{label}: K3 {launches[label]}")
    return launches


def phase_serve(torch, gpu_line):
    """LLMServer at Llama-3-8B widths and full depth, bf16 random weights
    from seed 0, one model shared by four engine configurations: the
    paged burst (profiled a second time), then (i) the contiguous cache,
    (ii) paged with chunked prefill and decode_block=4, (iii) paged with
    a registered 1000-token prefix. Returns each path's launches and the
    paged burst's engine TTFT p50, TPOT p50 and decode tokens/s."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMServer

    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    t0 = time.time()
    model = Llama(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: Llama-3-8B widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B params bf16, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    base = dict(max_slots=8, max_seq_len=2048, prefill_buckets=SERVE_BUCKETS,
                max_prefill_batch=4)

    def server_for(**engine_config):
        return LLMServer(lambda: (model, None),
                         engine_config={**base, **engine_config},
                         device="cuda")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PLENS]
    bodies = [{"prompt": p, "max_tokens": SERVE_NEW} for p in prompts]
    bodies[2].update(temperature=0.8, top_p=0.9)
    bodies[5]["stream"] = True
    launches = {}

    precompile_probe(torch, model, base, prompts[3], gpu_line)

    server = server_for(kv_page_size=16)
    stats, launches["serve"] = serve_burst(torch, server, bodies, "serve",
                                           gpu_line, cfg.vocab_size)
    k1, k3 = launches["serve"].values()
    check(k1 > 0 and k3 > 0,
          f"kernels not launched on the main path: K1 {k1}, K3 {k3}")
    tpot_block1 = stats.get("tpot_p50_ms")
    serve_stats = {"ttft_p50_ms": stats["ttft_breakdown_p50_ms"]["total_ms"],
                   "tpot_p50_ms": tpot_block1,
                   "decode_tok_s": stats["decode_tok_s"]}
    print(f"serve: main-path launches K1 {k1}, K3 {k3} (K1: one per layer "
          f"per prefill group; K3: one per layer per decode step)",
          flush=True)
    gpu_profile(torch, lambda: burst(server, bodies), "serve-profile",
                gpu_line)
    close_server(torch, server)

    # (i) the contiguous slot cache: attention is the einsum over each
    # slot's whole row (no kernel, as in the reference); 9 slots x 2048
    # positions repeated to 32 heads in fp32 is ~300 MB per tensor per
    # layer, transient
    server = server_for(kv_page_size=0)
    _, launches["serve-contiguous"] = serve_burst(
        torch, server, bodies, "serve-contiguous", gpu_line, cfg.vocab_size)
    check(sum(launches["serve-contiguous"].values()) == 0,
          f"the contiguous cache launched paged kernels: "
          f"{launches['serve-contiguous']}")
    close_server(torch, server)

    # (ii) paged, prompts past 512 tokens chunked, 4 decode steps a
    # dispatch; beside it the same with 1 step a dispatch, and with 4 and
    # a pipeline of 3 dispatches (12 steps of termination lag, near the
    # 10 of one-step dispatches; 10 dispatches of 4 are 40)
    tpots = {}
    for label, kw in CHUNKED_VARIANTS:
        server = server_for(kv_page_size=16, prefill_chunk=512, **kw)
        stats, launches[label] = serve_burst(
            torch, server, bodies, label, gpu_line, cfg.vocab_size)
        k1, k3 = launches[label].values()
        check(k1 > 0 and k3 > 0, f"{label}: K1 {k1}, K3 {k3}")
        tpots[label] = stats.get("tpot_p50_ms")
        close_server(torch, server)
    print(f"serve-chunked: TPOT p50 ms by configuration {json.dumps(tpots)}"
          f"; the unchunked serve burst (decode_block=1) {tpot_block1} ms "
          f"[{gpu_line}]", flush=True)

    # (iii) paged, one 1000-token prefix registered through LLMServer's
    # cached_prefixes (a fresh prefill: K1), 8 requests of prefix + suffix
    prefix = rng.randint(0, cfg.vocab_size, PREFIX_LEN).tolist()
    fa.flash_attention_fwd.launches = 0
    server = LLMServer(lambda: (model, None),
                       engine_config={**base, "kv_page_size": 16,
                                      "max_prefixes": 2},
                       cached_prefixes=[prefix], device="cuda")
    k1_reg = fa.flash_attention_fwd.launches
    check(k1_reg == cfg.n_layers,
          f"prefix registration launched K1 {k1_reg} times, want one "
          f"fresh prefill ({cfg.n_layers} layers)")
    launches["serve-prefix-register"] = {"flash_fwd (K1)": k1_reg}
    pbodies = [{"prompt": prefix + rng.randint(0, cfg.vocab_size,
                                               n).tolist(),
                "max_tokens": SERVE_NEW} for n in SUFFIX_LENS]
    stats, launches["serve-prefix"] = serve_burst(
        torch, server, pbodies, "serve-prefix", gpu_line, cfg.vocab_size)
    check(launches["serve-prefix"]["paged_decode (K3)"] > 0,
          f"serve-prefix: K3 {launches['serve-prefix']}")
    saved = stats["prefix_tokens_saved"]
    print(f"serve-prefix: prefix_tokens_saved {saved} (want "
          f"{len(pbodies)} x {PREFIX_LEN}), registration K1 launches "
          f"{k1_reg}", flush=True)
    check(saved == len(pbodies) * PREFIX_LEN,
          f"prefix_tokens_saved {saved}, want {len(pbodies) * PREFIX_LEN}")
    close_server(torch, server)

    launches.update(serve_controls(torch, model, base, rng, gpu_line))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, serve_stats


PARITY_PLENS = (17, 60, 200, 300)
PARITY_NEW = 16
PARITY_PREFIX = 100     # of the 300-token prompt: 6 pages of 16 and a part
# engine configurations held to the reference loop: (label, config)
PARITY_CASES = [
    ("paged", dict(kv_page_size=16)),
    ("contiguous batch 1", dict(kv_page_size=0, max_prefill_batch=1)),
    ("contiguous batch 4", dict(kv_page_size=0, max_prefill_batch=4)),
    ("paged chunk 64", dict(kv_page_size=16, prefill_chunk=64)),
    ("contiguous chunk 64", dict(kv_page_size=0, prefill_chunk=64)),
    ("paged decode_block 4", dict(kv_page_size=16, decode_block=4)),
    ("contiguous decode_block 4", dict(kv_page_size=0, decode_block=4)),
    ("paged prefix", dict(kv_page_size=16, max_prefixes=2)),
    ("contiguous prefix", dict(kv_page_size=0, max_prefixes=2)),
]


def einsum_only(q, k, v, *, impl="auto", **kw):
    """`multi_head_attention` held to the einsum path whatever route the
    model's attn_impl names: the plain loops' attention."""
    from ray_tpu_torch.ops import einsum_attention
    return einsum_attention(q, k, v, **kw)


def plain_greedy(torch, model, prompts, module=None):
    """PARITY_NEW greedy tokens of each prompt from a full-recompute loop
    through `model` with no cache and its attention held to the einsum
    path (`multi_head_attention` of `module`, default models/llama.py,
    which Mixtral's attention shares), so the reference shares no kernel
    with the engine."""
    from unittest import mock

    from ray_tpu_torch.models import llama as llama_module
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    want = []
    zero_counters(fa)
    with torch.no_grad(), mock.patch.object(
            module or llama_module, "multi_head_attention", einsum_only):
        for p in prompts:
            seq = list(p)
            for _ in range(PARITY_NEW):
                out = model(torch.tensor([seq], device="cuda"))
                logits = out[0] if isinstance(out, tuple) else out
                seq.append(int(torch.argmax(logits[0, -1])))
            want.append(seq[len(p):])
    check(fa.flash_attention_fwd.launches == 0,
          "the plain reference launched K1")
    return want


def phase_parity(torch):
    """fp32 greedy tokens of the engine in every PARITY_CASES
    configuration against a full-recompute loop through the same model
    with no cache and its attention held to the einsum path. A prefix
    case registers the 300-token prompt's first PARITY_PREFIX tokens and
    submits the rest with its prefix_id, beside the full prompt. Returns
    the prompts and the loop's tokens."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    model = Llama(cfg, device="cuda", seed=1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PARITY_PLENS]
    want = plain_greedy(torch, model, prompts)
    for i, w in enumerate(want):
        print(f"parity: prompt {i} ({len(prompts[i])} tokens) plain {w}",
              flush=True)

    engine_parity(torch, model, prompts, want, "parity", PARITY_CASES,
                  dict(max_slots=4, max_seq_len=2048,
                       prefill_buckets=(32, 64, 128, 256, 512)),
                  prefix=PARITY_PREFIX)
    print(f"parity: ok (fp32, TF32 off, 4 layers of Llama-3-8B widths, "
          f"{len(PARITY_CASES)} engine configurations; reference einsum "
          f"attention, 0 kernel launches)", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return prompts, want


# controls phase: the engine's request controls at the parity phase's
# shape, held to the full-recompute loop with the same rules applied on
# the host
CONTROLS_NEW = 24
CONTROLS_EOS = 128001           # Llama-3's <|end_of_text|>
SPEC_K = 4
LOGPROB_ATOL = 1e-3     # fp32, TF32 off: the engine's cached attention
                        # and the loop's full recompute sum in other orders
SPEC_CANDIDATES = 6     # random prompts whose greedy output is searched
SPEC_SEARCH = 40        # ... at this many starting points for a prompt
                        # speculation never backs off on


def plain_controls(torch, model, prompt, n_new, presence_penalty=0.0,
                   frequency_penalty=0.0, logit_bias=None, fsm=None,
                   eos=CONTROLS_EOS):
    """Greedy tokens and their fp32 logprobs (of the raw distribution)
    from the full-recompute einsum loop, with the engine's rules applied
    on the host: bias = logit_bias - presence * (count > 0) - frequency *
    count over the tokens generated so far, then the FSM's mask, then
    argmax; the request ends at EOS, a complete FSM match or n_new."""
    from unittest import mock

    from ray_tpu_torch.models import llama as llama_module
    V = model.cfg.vocab_size
    static = torch.zeros(V, device="cuda")
    for t, b in (logit_bias or {}).items():
        static[int(t)] = float(b)
    counts = torch.zeros(V, dtype=torch.int32, device="cuda")
    seq, toks, lps = list(prompt), [], []
    state = fsm.start if fsm is not None else None
    with torch.no_grad(), mock.patch.object(
            llama_module, "multi_head_attention", einsum_only):
        for _ in range(n_new):
            logits, _ = model(torch.tensor([seq], device="cuda"))
            logits = logits[0, -1].float()
            bias = (static - presence_penalty * (counts > 0)
                    - frequency_penalty * counts)
            adj = logits + bias
            if fsm is not None:
                allow = torch.from_numpy(fsm.allowed(state)).cuda()
                adj = adj.masked_fill(~allow, float("-inf"))
            tok = int(torch.argmax(adj))
            toks.append(tok)
            lps.append(float(torch.log_softmax(logits, -1)[tok]))
            counts[tok] += 1
            seq.append(tok)
            if tok == eos:
                break
            if fsm is not None:
                state = fsm.advance(state, tok)
                if state < 0 or fsm.is_complete(state):
                    break
    return toks, lps


def propose_ngram(hist, k=SPEC_K, order=2, lookback=256):
    """The engine's `_propose_ngram`: the k tokens after the latest
    earlier occurrence of the trailing `order`-gram, or None."""
    key = hist[-order:]
    lo = max(0, len(hist) - order - 1 - max(order + 1, lookback))
    for i in range(len(hist) - order - 1, lo - 1, -1):
        if hist[i:i + order] == key:
            return hist[i + order:i + order + k] or None
    return None


def spec_schedule(prompt, toks, k=SPEC_K):
    """(verify steps, accepted proposals, backed off) of one speculating
    request whose greedy output is `toks`, stepped as the engine steps
    it alone: synchronously, a verify step whenever the history proposes
    (emitting the proposals the output confirms and the token after
    them), a plain step otherwise; 8 plain steps in a row back it off to
    pipelined decode, where this count stops."""
    hist, i, idle, steps, accepted = list(prompt) + toks[:1], 1, 0, 0, 0
    while i < len(toks):
        prop = propose_ngram(hist, k)
        n = 1
        if prop:
            idle = 0
            steps += 1
            while n <= len(prop) and prop[n - 1] == toks[i + n - 1] \
                    and i + n < len(toks):
                n += 1
            accepted += n - 1
        else:
            idle += 1
            if idle >= 8:
                return steps, accepted, True
        hist.extend(toks[i:i + n])
        i += n
    return steps, accepted, False


def phase_controls(torch):
    """The request controls at the parity phase's shape (4 fp32 layers
    of Llama-3-8B widths, TF32 off), on the paged and contiguous caches,
    each held to `plain_controls`: n-gram speculation (K = 4) on the
    prompt whose greedy output repeats most (tokens identical, verify
    steps run, proposals accepted, fewer decode dispatches than
    tokens); presence / frequency penalties and logit_bias (+100 forces
    a token, -100 blocks one); guided choices of token ids alone and
    with penalties (every output accepted by its FSM); logprobs within
    LOGPROB_ATOL of the loop's fp32 log_softmax. Then an expired
    deadline raises DeadlineExceededError, and a stall of the loop past
    the watchdog makes the stream raise EngineWedgedError and
    LLMServer.check_health raise."""
    import numpy as np
    from ray_tpu_torch.exceptions import (DeadlineExceededError,
                                          EngineWedgedError)
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.serve.llm import (LLMEngine, LLMEngineConfig,
                                         LLMServer, TokenFSM)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    model = Llama(cfg, device="cuda", seed=1)
    V = cfg.vocab_size
    rng = np.random.RandomState(7)
    base = dict(max_slots=4, max_seq_len=2048, eos_token_id=CONTROLS_EOS,
                prefill_buckets=(32, 64, 128, 256, 512))

    # speculation: a random prompt followed by the first j tokens of the
    # model's own greedy continuation is continued by the rest of it; of
    # those prompts, the one whose continuation speculation accepts most
    # proposals on without backing off (then every step is synchronous
    # and the engine's counts are exactly `spec_schedule`'s)
    best = None
    for _ in range(SPEC_CANDIDATES):
        p = rng.randint(0, V, 24).tolist()
        g, _ = plain_controls(torch, model, p, SPEC_SEARCH + CONTROLS_NEW)
        for j in range(min(SPEC_SEARCH, len(g) - CONTROLS_NEW) + 1):
            cont = g[j:j + CONTROLS_NEW]
            steps, accepted, backed_off = spec_schedule(p + g[:j], cont)
            if not backed_off and accepted and (
                    best is None or accepted > best[0]):
                best = (accepted, steps, p + g[:j], cont)
    check(best is not None, "controls: no prompt found that speculation "
                            "accepts a proposal on without backing off")
    spec_accepted, spec_steps, spec_prompt, spec_want = best
    print(f"controls: speculation prompt of {len(spec_prompt)} tokens: "
          f"plain loop {spec_want}; expected {spec_steps} verify steps, "
          f"{spec_accepted} accepted", flush=True)

    # penalties, logit_bias and guided choices, all in one batch
    prompts = [rng.randint(0, V, n).tolist() for n in (17, 60, 200, 40)]
    plain0, _ = plain_controls(torch, model, prompts[0], CONTROLS_NEW)
    forced, blocked = int(rng.randint(0, V)), plain0[0]
    choices = [rng.randint(0, V, n).tolist() for n in (3, 5, 4)]

    def fsm():
        return TokenFSM.from_choices(choices, vocab_size=V,
                                     eos_id=CONTROLS_EOS)

    jobs = [(prompts[0], dict(presence_penalty=1.5,
                              logit_bias={plain0[1]: 2.0})),
            (prompts[1], dict(frequency_penalty=1.0)),
            (prompts[2], dict(presence_penalty=-0.5, frequency_penalty=0.8,
                              logit_bias={forced: 100.0})),
            (prompts[0], dict(logit_bias={blocked: -100.0})),
            (prompts[3], dict(guided_fsm=fsm())),
            (prompts[1], dict(guided_fsm=fsm(), presence_penalty=2.0,
                              logit_bias={choices[2][0]: 3.0})),
            (prompts[2], dict())]
    want = [plain_controls(torch, model, p, CONTROLS_NEW,
                           fsm=fsm() if "guided_fsm" in kw else None,
                           **{k: v for k, v in kw.items()
                              if k != "guided_fsm"})
            for p, kw in jobs]
    check(want[2][0] == [forced] * CONTROLS_NEW,
          f"controls: logit_bias +100 did not force the loop: {want[2][0]}")
    check(want[3][0][0] != blocked,
          "controls: logit_bias -100 did not block the loop's token")

    for kv in (16, 0):
        label = "paged" if kv else "contiguous"
        spec = LLMEngine(model, None, LLMEngineConfig(
            **base, kv_page_size=kv, ngram_speculation=SPEC_K),
            device="cuda")
        try:
            got = spec.generate_sync(spec_prompt,
                                     max_new_tokens=CONTROLS_NEW)
            st = spec.get_stats()
        finally:
            spec.shutdown()
        print(f"controls: {label}: speculation {got}; verify steps "
              f"{st['spec_steps']}, accepted {st['spec_accepted']}, decode "
              f"dispatches {st['decode_steps']} for {len(got)} tokens",
              flush=True)
        check(got == spec_want, f"controls: {label}: speculative tokens "
                                f"differ from the plain loop")
        check((st["spec_steps"], st["spec_accepted"])
              == (spec_steps, spec_accepted) and spec_accepted > 0,
              f"controls: {label}: verify steps and accepted proposals "
              f"differ from the schedule's")
        check(st["decode_steps"] < len(got),
              f"controls: {label}: {st['decode_steps']} decode dispatches "
              f"for {len(got)} tokens")

        engine = LLMEngine(model, None, LLMEngineConfig(
            **base, kv_page_size=kv, logprobs=True), device="cuda")
        try:
            rids = [engine.submit(p, max_new_tokens=CONTROLS_NEW, **kw)
                    for p, kw in jobs]
            out = [list(engine.stream_detailed(r)) for r in rids]
            with_deadline = None
            try:
                engine.submit(prompts[0], deadline_ts=time.time() - 1)
            except DeadlineExceededError as e:
                with_deadline = e
        finally:
            engine.shutdown()
        err = 0.0
        for i, (o, (w_toks, w_lps)) in enumerate(zip(out, want)):
            toks = [t for t, _ in o]
            if toks != w_toks:
                print(f"controls: {label}: request {i} engine {toks} plain "
                      f"{w_toks}", flush=True)
            check(toks == w_toks, f"controls: {label}: request {i}'s tokens "
                                  f"differ from the plain loop")
            err = max([err] + [abs(lp - w) for (_, lp), w in zip(o, w_lps)])
        for i in (4, 5):
            f = fsm()
            state = f.start
            for t in [t for t, _ in out[i]]:
                check(bool(f.allowed(state)[t]),
                      f"controls: {label}: guided request {i} left its FSM")
                state = f.advance(state, t)
            check(f.is_accepting(state),
                  f"controls: {label}: guided request {i} did not finish a "
                  f"choice")
        print(f"controls: {label}: penalties, logit_bias, guided choices "
              f"(alone and penalised) equal to the plain loop; logprobs max "
              f"abs err {err:.3g} (tolerance {LOGPROB_ATOL})", flush=True)
        check(err <= LOGPROB_ATOL, f"controls: {label}: logprobs differ by "
                                   f"{err}")
        check(with_deadline is not None,
              f"controls: {label}: an expired deadline was accepted")

    server = LLMServer(lambda: (model, None), engine_config={
        **base, "kv_page_size": 16, "watchdog_s": 0.2}, device="cuda")
    try:
        check(len(server.engine.generate_sync(prompts[0],
                                              max_new_tokens=4)) == 4,
              "controls: watchdog warm-up request failed")
        server.check_health()
        server.engine._chaos_stall(2.5)     # > 10 x 0.2 s
        rid = server.engine.submit(prompts[0], max_new_tokens=8)
        wedged = None
        try:
            list(server.engine.stream(rid))
        except EngineWedgedError as e:
            wedged = e
        check(wedged is not None, "controls: a stalled loop was not "
                                  "declared wedged")
        unhealthy = None
        try:
            server.check_health()
        except EngineWedgedError as e:
            unhealthy = e
        check(unhealthy is not None,
              "controls: check_health passed on a wedged engine")
    finally:
        server.shutdown()
    print("controls: ok (expired deadline refused; a 2.5 s stall under "
          "watchdog_s 0.2 wedged the engine, its stream and check_health "
          "raised EngineWedgedError)", flush=True)
    del model, server
    gc.collect()
    torch.cuda.empty_cache()


# paged engines of ROUTE_LAYERS layers whose shapes or type K1 or K3 do
# not take: (label, model widths, compute and weight type, K1 taken on
# fresh prefill). Head dim 96 at Phi-3-mini's widths (d 3072, 32 heads
# and kv heads, d_ff 8192, vocab 32064); MQA at Llama-3-8B's widths with
# one kv head (a group of 32, past K3's MAX_REP of 16); Llama-3-8B in
# fp16. K3 takes none of them. The fp32 cases are held token for token
# to plain_greedy; the fp16 one must finish with in-vocab tokens.
ROUTE_LAYERS = 2
_LLAMA3_8B = dict(vocab_size=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                  d_ff=14336, max_seq_len=8192)
ROUTE_CASES = [
    ("head dim 96", dict(vocab_size=32064, d_model=3072, n_heads=32,
                         n_kv_heads=32, d_ff=8192, max_seq_len=4096),
     "float32", False),
    ("MQA 32/1", dict(_LLAMA3_8B, n_kv_heads=1), "float32", True),
    ("fp16", _LLAMA3_8B, "float16", False),
]


def phase_routes(torch):
    """The paged engine (page 16) at each ROUTE_CASES configuration:
    PARITY_PLENS prompts of PARITY_NEW greedy tokens, the K1 and K3
    counters zeroed just before and read just after; each counter must
    be 0 where the route takes no kernel (K1 > 0 where it does)."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    for label, widths, dt_name, takes_k1 in ROUTE_CASES:
        dt = getattr(torch, dt_name)
        cfg = LlamaConfig(**widths, n_layers=ROUTE_LAYERS, dtype=dt,
                          param_dtype=dt)
        model = Llama(cfg, device="cuda", seed=3)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in PARITY_PLENS]
        want = plain_greedy(torch, model, prompts) if dt == torch.float32 \
            else None
        engine = LLMEngine(model, None, LLMEngineConfig(
            max_slots=4, max_seq_len=2048, kv_page_size=16,
            prefill_buckets=(32, 64, 128, 256, 512)), device="cuda")
        zero_counters(fa)
        pa.paged_decode_attention.launches = 0
        replays = graph_replays()
        try:
            rids = [engine.submit(p, max_new_tokens=PARITY_NEW)
                    for p in prompts]
            got = [list(engine.stream(r)) for r in rids]
            state = engine.get_stats()["decode_graphs"]
        finally:
            engine.shutdown()
        note_graphs(f"routes: {label}", state, graph_replays() - replays)
        k1 = fa.flash_attention_fwd.launches
        k3 = pa.paged_decode_attention.launches
        print(f"routes: {label}: D {cfg.head_dim}, Hq {cfg.n_heads}, Hkv "
              f"{cfg.n_kv_heads}, {dt_name}, {ROUTE_LAYERS} layers: K1 "
              f"{k1}, K3 {k3} launches (want K1 "
              f"{'> 0' if takes_k1 else '0'}, K3 0)", flush=True)
        check(k3 == 0 and (k1 > 0 if takes_k1 else k1 == 0),
              f"routes: {label}: K1 {k1}, K3 {k3}")
        check(all(len(g) == PARITY_NEW and all(0 <= t < cfg.vocab_size
                                               for t in g) for g in got),
              f"routes: {label}: a request did not finish with "
              f"{PARITY_NEW} in-vocab tokens: {got}")
        if want is not None:
            for i, (g, w) in enumerate(zip(got, want)):
                if g != w:
                    print(f"routes: {label}: request {i} engine {g} plain "
                          f"{w}", flush=True)
            check(got == want, f"routes: {label}: engine greedy tokens "
                               f"differ from the plain full-recompute loop")
        print(f"routes: {label}: ok ({len(got)} requests"
              f"{', equal to the plain loop' if want else ''})", flush=True)
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()


# zoo phase: every model family the engine serves, and int8
ZOO_BASE = dict(max_slots=8, max_seq_len=2048, prefill_buckets=SERVE_BUCKETS,
                max_prefill_batch=4, kv_page_size=16)
# Mixtral-8x7B widths with the depth cut from 32 to 8 layers: 8 layers
# hold 11.6 B params (23.7 GB in bf16); 32 hold 46.7 B (93 GB), more
# than one 80 GB card
MIXTRAL_LAYERS = 8
MIXTRAL_PLENS = [20, 40, 80, 120, 200, 300, 400, 500]
# no-drop parity: capacity_factor = n_experts / experts_per_token makes
# the capacity equal to the call's token count, so a request's output
# does not depend on its batch; prompts stay short, the (G, E, C)
# dispatch tensors grow as G**2
MIXTRAL_PARITY_LAYERS = 2
MIXTRAL_PARITY_PLENS = (9, 24, 40, 64)
INT8_PARITY_LAYERS = 4
INT8_BYTES_RATIO = 0.6      # int8 weights + bf16 embedding and head
GPT2_PLENS = [20, 50, 100, 200, 350, 500, 700, 900]
GPT2_BUCKETS = (32, 64, 128, 256, 512, 1024)
VIT_IMAGES = 8
VIT_ITERS = 10
# ViT-base fp32 (TF32 off) through K1's fp32 kernel against the einsum
# path: both sum the scores in fp32 in other orders (K1 4.8e-7 apart at
# the kernel), carried through 12 blocks and the head to logits of
# order 1
VIT_ATOL = 1e-3
# CLIP and ResNetLite, fp32 with TF32 off, on the card against the same
# weights on the CPU: cuDNN/cuBLAS and oneDNN sum in other orders
ZOO_CPU_ATOL = 1e-4


def release(torch):
    gc.collect()
    torch.cuda.empty_cache()


def built(torch, label, model, t0):
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"{label}: {n / 1e9:.3f}B params, built in {time.time() - t0:.1f}"
          f" s", flush=True)


def peak(torch, label, gpu_line):
    gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: peak memory {gib:.2f} GiB (max_memory_allocated) "
          f"[{gpu_line}]", flush=True)


def zoo_bodies(vocab, plens, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, vocab, n).tolist(),
             "max_tokens": SERVE_NEW} for n in plens]


def zoo_burst(torch, model, engine_config, bodies, label, gpu_line,
              profile=False):
    """A paged LLMServer burst of `bodies` on `model`; K1 and K3 must
    both have run. With `profile`, the same burst again under the
    profiler (after the counters were read). Returns the burst's
    launches."""
    from ray_tpu_torch.serve.llm import LLMServer
    server = LLMServer(lambda: (model, None), engine_config=engine_config,
                       device="cuda")
    _, launches = serve_burst(torch, server, bodies, label, gpu_line,
                              model.cfg.vocab_size)
    if profile:
        gpu_profile(torch, lambda: burst(server, bodies), label + "-profile",
                    gpu_line)
    close_server(torch, server)
    k1, k3 = launches.values()
    check(k1 > 0 and k3 > 0, f"{label}: K1 {k1}, K3 {k3}")
    return launches


def engine_parity(torch, model, prompts, want, label, configs, base,
                  prefix=0):
    """Greedy tokens of a fresh engine in each (name, config) against
    `want`; on the paged cache K1 and K3 must have run. A config with
    max_prefixes registers the last prompt's first `prefix` tokens and
    submits the rest with its prefix_id, beside the full prompt."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
    for name, kw in configs:
        engine = LLMEngine(model, None, LLMEngineConfig(**base, **kw),
                           device="cuda")
        zero_counters(fa)
        pa.paged_decode_attention.launches = 0
        replays = graph_replays()
        try:
            if "max_prefixes" in kw:
                full = prompts[-1]
                pid = engine.register_prefix(full[:prefix])
                rids = [engine.submit(full[prefix:],
                                      max_new_tokens=PARITY_NEW,
                                      prefix_id=pid),
                        engine.submit(full, max_new_tokens=PARITY_NEW)]
                expect = [want[-1], want[-1]]
            else:
                rids = [engine.submit(p, max_new_tokens=PARITY_NEW)
                        for p in prompts]
                expect = want
            got = [list(engine.stream(r)) for r in rids]
            stats = engine.get_stats()
            saved = stats["prefix_tokens_saved"]
        finally:
            engine.shutdown()
        note_graphs(f"{label}: {name}", stats["decode_graphs"],
                    graph_replays() - replays,
                    paged=bool(kw.get("kv_page_size")))
        k1 = fa.flash_attention_fwd.launches
        k3 = pa.paged_decode_attention.launches
        for i, (g, w) in enumerate(zip(got, expect)):
            if g != w:
                print(f"{label}: {name}: request {i} engine {g} plain {w}",
                      flush=True)
        check(got == expect, f"{label}: {name}: engine greedy tokens differ "
                             f"from the plain full-recompute loop")
        if kw.get("kv_page_size"):
            check(k1 > 0 and k3 > 0, f"{label}: {name}: K1 {k1}, K3 {k3}")
        if "max_prefixes" in kw:
            check(saved == prefix,
                  f"{label}: {name}: prefix_tokens_saved {saved}")
        print(f"{label}: {name}: ok ({len(got)} requests equal to the plain "
              f"loop; K1 {k1}, K3 {k3} launches)", flush=True)


# (label, rows): a prefill group of 4 prompts in the 512 bucket, and a
# decode step of the 8 slots and the scratch slot
MOE_SHAPES = (("prefill 4 x 512", 2048), ("decode 9 x 1", 9))


def moe_times(torch, moe, gpu_line):
    """Device time of one MoE layer at MOE_SHAPES, whole and in its two
    parts: routing with dispatch and combine (the experts replaced by
    the identity) and the expert products alone on (E, C, d)."""
    from ray_tpu_torch.ops.moe import expert_capacity, moe_dispatch_combine
    cfg = moe.cfg
    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, g in MOE_SHAPES:
        x = torch.randn(1, g, cfg.d_model, device="cuda", generator=gen) \
            .to(cfg.dtype)
        tokens = x[0]
        logits = tokens.float() @ moe.router_kernel.float()
        cap = expert_capacity(g, cfg.n_experts, cfg.experts_per_token,
                              cfg.capacity_factor)
        batch = torch.randn(cfg.n_experts, cap, cfg.d_model, device="cuda",
                            generator=gen).to(cfg.dtype)
        wg, wu, wd = (moe.experts_gate_kernel, moe.experts_up_kernel,
                      moe.experts_down_kernel)

        def experts():
            return torch.bmm(torch.nn.functional.silu(torch.bmm(batch, wg))
                             * torch.bmm(batch, wu), wd)

        with torch.no_grad():
            whole = time_ms(lambda: moe(x))
            route = time_ms(lambda: moe_dispatch_combine(
                tokens, logits, lambda b: b, k=cfg.experts_per_token,
                capacity=cap))
            expert = time_ms(experts)
        flops = 6 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff
        print(f"zoo-mixtral: MoE layer at {label} (G {g}, C {cap}): whole "
              f"{whole:.4f} ms, routing + dispatch/combine {route:.4f} ms, "
              f"experts {expert:.4f} ms ({flops / expert / 1e9:.1f} TFLOP/s "
              f"on E x C rows) [{gpu_line}]", flush=True)


def zoo_mixtral(torch, gpu_line):
    """Mixtral-8x7B widths, MIXTRAL_LAYERS layers, bf16: the paged
    burst; then 2 fp32 layers at no-drop capacity held to the einsum
    loop on both caches."""
    import numpy as np
    from ray_tpu_torch.models import Mixtral, MixtralConfig
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg = MixtralConfig.mixtral_8x7b(n_layers=MIXTRAL_LAYERS,
                                     dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)
    model = Mixtral(cfg, device="cuda", seed=0)
    built(torch, f"zoo-mixtral: Mixtral-8x7B widths, {cfg.n_layers} layers "
                 f"bf16, {cfg.n_experts} experts top-{cfg.experts_per_token}"
                 f", capacity factor {cfg.capacity_factor}", model, t0)
    launches = zoo_burst(torch, model, ZOO_BASE, zoo_bodies(
        cfg.vocab_size, MIXTRAL_PLENS, 4), "zoo-mixtral", gpu_line,
        profile=True)
    peak(torch, "zoo-mixtral", gpu_line)
    moe_times(torch, model.layer_0.moe, gpu_line)
    del model
    release(torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    no_drop = cfg.n_experts / cfg.experts_per_token
    cfg = MixtralConfig.mixtral_8x7b(
        n_layers=MIXTRAL_PARITY_LAYERS, dtype=torch.float32,
        param_dtype=torch.float32, remat=False, capacity_factor=no_drop)
    model = Mixtral(cfg, device="cuda", seed=5)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in MIXTRAL_PARITY_PLENS]
    want = plain_greedy(torch, model, prompts)
    engine_parity(torch, model, prompts, want, "zoo-mixtral-parity",
                  [("paged", dict(kv_page_size=16)),
                   ("contiguous", dict(kv_page_size=0))],
                  dict(max_slots=4, max_seq_len=256,
                       prefill_buckets=(32, 64, 128)))
    del model
    release(torch)
    return launches


def zoo_int8(torch, gpu_line):
    """Llama-3-8B (32 layers, bf16) quantized on the card: weight bytes,
    one down_proj's device time int8 against bf16, the paged burst; then
    4 fp32 int8 layers held to the einsum loop on the paged engine."""
    import numpy as np
    import torch.nn.functional as F
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.quant import quantize_llama_params, quantized_bytes
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    model = Llama(cfg, device="cuda", seed=0)
    bf16_bytes = quantized_bytes(model)
    t0 = time.time()
    qstate = quantize_llama_params(model.state_dict())
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    qmodel = Llama(dataclasses.replace(cfg, quant="int8"), device="cuda",
                   seed=0)
    qmodel.load_state_dict(qstate)
    del qstate
    int8_bytes = quantized_bytes(qmodel)
    print(f"zoo-int8: Llama-3-8B quantized on the card in {t_quant:.2f} s: "
          f"{int8_bytes / 1e9:.3f} GB against bf16 {bf16_bytes / 1e9:.3f} GB"
          f" ({int8_bytes / bf16_bytes:.3f}x; want < {INT8_BYTES_RATIO})",
          flush=True)
    check(int8_bytes < INT8_BYTES_RATIO * bf16_bytes,
          f"int8 weights {int8_bytes} B, bf16 {bf16_bytes} B")

    # one down_proj at a decode step's 8 rows: the int8 product (a
    # transient bf16 copy of the weight, then cuBLAS) against the bf16
    # product on the same activations
    w = model.layer_0.mlp.down_proj.weight
    qd = qmodel.layer_0.mlp.down_proj
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, cfg.d_ff, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    with torch.no_grad():
        err = (qd(x).float() - F.linear(x, w).float()).abs().max().item()
        ms_q = time_ms(lambda: qd(x))
        ms_b = time_ms(lambda: F.linear(x, w))
    n_w = w.numel()
    print(f"zoo-int8: down_proj x (8, {cfg.d_ff}) bf16: int8 {ms_q:.4f} ms "
          f"against bf16 {ms_b:.4f} ms (weight {n_w / 1e6:.1f} M; bytes "
          f"bound bf16 {2 * n_w / PEAK_BYTES * 1e3:.4f} ms, int8 read once "
          f"{n_w / PEAK_BYTES * 1e3:.4f} ms); max |int8 - bf16| {err:.4f} "
          f"[{gpu_line}]", flush=True)
    del model, w
    release(torch)
    bodies = zoo_bodies(cfg.vocab_size, SERVE_PLENS, 0)
    launches = zoo_burst(torch, qmodel, ZOO_BASE, bodies, "zoo-int8",
                         gpu_line, profile=True)
    peak(torch, "zoo-int8", gpu_line)
    del qmodel
    release(torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=INT8_PARITY_LAYERS,
                                dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    fp = Llama(cfg, device="cuda", seed=6)
    qstate = quantize_llama_params(fp.state_dict())
    del fp
    model = Llama(dataclasses.replace(cfg, quant="int8"), device="cuda",
                  seed=6)
    model.load_state_dict(qstate)
    del qstate
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PARITY_PLENS]
    want = plain_greedy(torch, model, prompts)
    engine_parity(torch, model, prompts, want, "zoo-int8-parity",
                  [("paged", dict(kv_page_size=16))],
                  dict(max_slots=4, max_seq_len=2048,
                       prefill_buckets=(32, 64, 128, 256, 512)))
    del model
    release(torch)
    return launches


def zoo_gpt2(torch, gpu_line):
    """GPT-2 small at full width and depth, bf16: the paged burst; then
    the same widths in fp32 held to the einsum loop on the paged
    engine."""
    import numpy as np
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models import gpt2 as gpt2_module
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg = GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = GPT2(cfg, device="cuda", seed=0)
    built(torch, f"zoo-gpt2: GPT-2 small, {cfg.n_layers} layers bf16, D "
                 f"{cfg.head_dim}", model, t0)
    launches = zoo_burst(
        torch, model, dict(ZOO_BASE, max_seq_len=1024,
                           prefill_buckets=GPT2_BUCKETS),
        zoo_bodies(cfg.vocab_size, GPT2_PLENS, 7), "zoo-gpt2",
        gpu_line)
    peak(torch, "zoo-gpt2", gpu_line)
    del model
    release(torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2Config.small(dtype=torch.float32)
    model = GPT2(cfg, device="cuda", seed=7)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PARITY_PLENS]
    want = plain_greedy(torch, model, prompts, gpt2_module)
    engine_parity(torch, model, prompts, want, "zoo-gpt2-parity",
                  [("paged", dict(kv_page_size=16))],
                  dict(max_slots=4, max_seq_len=1024,
                       prefill_buckets=(32, 64, 128, 256, 512)))
    del model
    release(torch)
    return launches


def zoo_vision(torch, gpu_line):
    """ViT-base on 8 images of 224^2: bf16 images/s with K1 once a
    layer, fp32 logits through K1 against the einsum path; CLIP debug,
    ResNetLite and entry() once each on the card (CLIP and ResNetLite
    against the CPU on the same weights)."""
    from unittest import mock

    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models import CLIP, CLIPConfig, ViT, ViTConfig
    from ray_tpu_torch.models import get_model
    from ray_tpu_torch.models import vit as vit_module
    from ray_tpu_torch.ops import einsum_attention
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    torch.cuda.reset_peak_memory_stats()
    cfg = ViTConfig.base(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = ViT(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(VIT_IMAGES, cfg.image_size, cfg.image_size,
                         cfg.channels, device="cuda", generator=gen)
    with torch.no_grad():
        model(images)                                   # warm
        torch.cuda.synchronize()
        zero_counters(fa)
        logits = model(images)
        torch.cuda.synchronize()
        k1 = fa.flash_attention_fwd.launches
        t0 = time.time()
        for _ in range(VIT_ITERS):
            model(images)
        torch.cuda.synchronize()
        dt = (time.time() - t0) / VIT_ITERS
    check(k1 == cfg.n_layers, f"zoo-vit: K1 {k1}, want {cfg.n_layers}")
    launches = {"flash_fwd (K1)": k1}
    check(tuple(logits.shape) == (VIT_IMAGES, cfg.num_classes)
          and bool(torch.isfinite(logits).all()), "zoo-vit: bad logits")
    print(f"zoo-vit: ViT-base bf16, {VIT_IMAGES} images of "
          f"{cfg.image_size}^2 (S {cfg.n_patches + 1}, D {cfg.head_dim}): "
          f"{dt * 1e3:.2f} ms a forward, {VIT_IMAGES / dt:.1f} images/s, "
          f"K1 {k1} launches a forward; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{gpu_line}]", flush=True)
    with torch.no_grad():
        gpu_profile(torch, lambda: model(images), "zoo-vit-profile",
                    gpu_line, top=5)
    del model
    release(torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ViT(ViTConfig.base(dtype=torch.float32), device="cuda", seed=1)
    with torch.no_grad():
        zero_counters(fa)
        got = model(images)
        k1 = fa.flash_attention_fwd.launches
        with mock.patch.object(vit_module, "multi_head_attention",
                               einsum_attention):
            want = model(images)
    err = (got - want).abs().max().item()
    print(f"zoo-vit-parity: fp32 logits through K1 ({k1} launches) against "
          f"the einsum path: max abs err {err:.3e} (tolerance {VIT_ATOL}, "
          f"logits up to {want.abs().max().item():.3f})", flush=True)
    check(k1 == cfg.n_layers and err <= VIT_ATOL, "zoo-vit-parity failed")
    del model
    release(torch)

    # CLIP debug and ResNetLite: the card against the CPU
    rng = torch.Generator().manual_seed(2)
    for label, build, args in (
            ("zoo-clip", lambda dev: CLIP(CLIPConfig.debug(
                dtype=torch.float32), device=dev, seed=2),
             (torch.randn(4, 32, 32, 3, generator=rng),
              torch.randint(0, 256, (4, 16), generator=rng,
                            dtype=torch.int32))),
            ("zoo-resnet", lambda dev: get_model(
                "resnet-lite", device=dev, seed=3),
             (torch.randn(4, 32, 32, 3, generator=rng),))):
        cpu, gpu = build("cpu"), build("cuda")
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want = cpu(*args)
            got = gpu(*[a.to("cuda") for a in args])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = max((g.cpu() - w).abs().max().item()
                  for g, w in zip(got, want))
        shapes = [tuple(g.shape) for g in got]
        print(f"{label}: outputs {shapes} on the card against the CPU: max "
              f"abs err {err:.3e} (tolerance {ZOO_CPU_ATOL})", flush=True)
        check(err <= ZOO_CPU_ATOL, f"{label}: the card differs from the CPU")
        del cpu, gpu

    forward, (params, tokens) = entry()
    with torch.no_grad():
        logits = forward(params, tokens)
    check(tuple(logits.shape) == (2, 128, 2048)
          and bool(torch.isfinite(logits).all()), "entry(): bad logits")
    print(f"zoo-entry: entry() on the card: logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite", flush=True)
    del forward, params, tokens, logits
    release(torch)
    return launches


def phase_zoo(torch, gpu_line):
    """The model zoo the engine serves: Mixtral, int8 Llama, GPT-2,
    ViT/CLIP/ResNetLite and entry(). Returns each burst's launches."""
    return {"zoo-mixtral": zoo_mixtral(torch, gpu_line),
            "zoo-int8": zoo_int8(torch, gpu_line),
            "zoo-gpt2": zoo_gpt2(torch, gpu_line),
            "zoo-vit": zoo_vision(torch, gpu_line)}


TRAIN_LAYERS = 8          # depth cut of the train phase (widths: full 8B)
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
PARITY_STEPS = 3
PARITY_RTOL = 1e-4        # fp32 GPU (K1/K2 fp32, cuBLAS fp32) vs CPU
# __graft_entry__._flagship_config() widths (copied: this script imports
# nothing of the JAX package)
FLAGSHIP = dict(vocab_size=2048, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=4, d_ff=1408, max_seq_len=512)


def zero_counters(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def read_counters(fa):
    return {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
            "flash_bwd_dq (K2a)": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv (K2b)": fa.flash_bwd_dkv.launches}


def phase_train(torch, gpu_line):
    """The slice's path at full width: Llama-3-8B widths with the depth
    cut to TRAIN_LAYERS, bf16 compute, fp32 master weights, remat, adamw
    with warmup_cosine, TRAIN_STEPS steps on one fixed batch."""
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     warmup_cosine)

    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Llama(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     device="cuda", generator=gen)}
    tx = make_optimizer("adamw", schedule=warmup_cosine(3e-4, 1,
                                                        TRAIN_STEPS))
    state, step = make_train_step(model, tx)(batch)
    torch.cuda.synchronize()
    print(f"train: Llama-3-8B widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B params fp32 master / bf16 compute, "
          f"remat={cfg.remat} ({cfg.remat_policy}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, built in {time.time() - t0:.1f} s",
          flush=True)
    zero_counters(fa)
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t1 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"train: step {i} loss {losses[-1]:.6f} grad_norm "
              f"{norms[-1]:.6f} time {times[-1] * 1e3:.1f} ms", flush=True)
    launches = read_counters(fa)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"train: median step {med * 1e3:.1f} ms (steps 1-"
          f"{TRAIN_STEPS - 1}), {TRAIN_BATCH * TRAIN_SEQ / med:.1f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) [{gpu_line}]", flush=True)
    print(f"train: launches {json.dumps(launches)} (expected K1 "
          f"2 x {cfg.n_layers} x {TRAIN_STEPS}: forward + remat recompute;"
          f" K2a, K2b {cfg.n_layers} x {TRAIN_STEPS})", flush=True)
    check(all(map(math.isfinite, losses + norms)),
          "non-finite loss or grad_norm")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    n = cfg.n_layers * TRAIN_STEPS
    check(launches == {"flash_fwd (K1)": 2 * n, "flash_bwd_dq (K2a)": n,
                       "flash_bwd_dkv (K2b)": n},
          f"unexpected launch counts {launches}")
    # one more step, profiled (after the counters were read)
    gpu_profile(torch, lambda: step(state, batch), "train-profile",
                gpu_line, top=12)
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"median_ms": med * 1e3, "peak_gib": peak / 2**30,
                      "losses": losses}


TRAINER_STEPS = 8         # the trainer phase: SpmdTrainer.fit, log_every 1
TRAINER_TIMED = 3         # profiler.timed_steps iterations of its step
TRAINER_WARMUP = 1        # its warmup steps (warmup_cosine: lr 0 at step 1)
TRAINER_LR = 1e-5         # its peak lr; the witness fits take
TRAINER_SPIKE_LR = 3e-4   # ... the train phase's, at which the loss spikes
RESUME_STEPS = 6          # trainer-resume: the uninterrupted run's steps,
RESUME_CRASH_AT = 4       # ... the batch whose draw fails the first run,
RESUME_EVERY = 2          # ... its checkpoints
# a resumed step against the uninterrupted run's: bit for bit expected
# (the same kernels on the same params, moments, counts and batches);
# the check allows a few ulps of a loss of order 7
RESUME_RTOL = 1e-6


def trainer_batches(rows, seq, seed, vocab):
    """Fresh seeded host batches of ids over the whole vocabulary, drawn
    by Zipf's law (the id of rank k with probability proportional to
    1/k, text's rank-frequency law) over a seeded permutation of the
    ids: the ids' frequencies are there to learn, so the loss falls over
    fresh batches, where uniform ids leave nothing to learn but the
    logits' spread. int64 as numpy makes them; the loader narrows them
    to int32."""
    import numpy as np
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    ids = rng.permutation(vocab)
    while True:
        yield {"tokens": ids[rng.choice(vocab, (rows, seq + 1), p=p)]}


def loader_check(torch, host):
    """device_put_iterator's CUDA path (pinned host memory, the copy on a
    side stream, the consumer's stream made to wait) against the host
    batches, the consumer's stream held busy by a device spin before
    each read: every batch int32 on the card and equal to its host
    batch."""
    from ray_tpu_torch.data import device_put_iterator
    got = []
    for b in device_put_iterator(iter(host), prefetch=2):
        torch.cuda._sleep(HOLD_CYCLES)
        t = b["tokens"]
        got.append((t.device.type, t.dtype, t.cpu().numpy()))
    ok = len(got) == len(host) and all(
        dev == "cuda" and dt == torch.int32 and (a == h["tokens"]).all()
        for (dev, dt, a), h in zip(got, host))
    return ok, len(got)


def phase_trainer(torch, gpu_line, train_stats):
    """The slice's front: SpmdTrainer.fit on the train phase's model
    (Llama-3-8B widths at TRAIN_LAYERS layers, bf16 compute, fp32 master
    weights, remat, adamw at TRAINER_LR, warmup TRAINER_WARMUP) over
    device_put_iterator of fresh seeded numpy batches of TRAIN_BATCH x
    (TRAIN_SEQ + 1) int64 tokens, Zipf over the whole vocabulary,
    TRAINER_STEPS steps logged every step, no checkpoint; a world of one
    takes the plain step. Then profiler.timed_steps of the same step,
    and the witness: the same fit at TRAINER_SPIKE_LR in bf16 and in
    fp32 compute. Returns the fit's K1/K2a/K2b launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.data import device_put_iterator
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.observability import profiler
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import (RunConfig, SpmdTrainer,
                                     SpmdTrainerConfig, make_optimizer,
                                     make_train_step, warmup_cosine)

    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device="cuda", seed=0)
    def trainer_config(model, lr):
        return SpmdTrainerConfig(model=model, total_steps=TRAINER_STEPS,
                                 log_every=1, warmup_steps=TRAINER_WARMUP,
                                 learning_rate=lr, device="cuda")

    def fit(tcfg, name):
        root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
        try:
            return SpmdTrainer(tcfg, data, run_config=RunConfig(
                name=name, storage_path=root)).fit()
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def data():
        return trainer_batches(TRAIN_BATCH, TRAIN_SEQ, 1, cfg.vocab_size)

    tcfg = trainer_config(model, TRAINER_LR)

    ok, n_batches = loader_check(
        torch, [b for b, _ in zip(data(), range(TRAINER_STEPS))])
    print(f"trainer: device_put_iterator on CUDA: {n_batches} int64 host "
          f"batches came out int32 on the card equal to the host's: {ok}",
          flush=True)
    check(ok, "trainer: device_put_iterator's batches differ from the "
              "host's")

    zero_counters(fa)
    res = fit(tcfg, "trainer")
    torch.cuda.synchronize()
    launches = read_counters(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = res.metrics_history
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    counted = TRAIN_BATCH * (TRAIN_SEQ + 1)     # the trainer's B x S
    step_ms = [counted / m["tokens_per_s"] * 1e3 for m in hist]
    med = statistics.median(step_ms[1:])
    print(f"trainer: SpmdTrainer.fit, Llama-3-8B widths, {cfg.n_layers} "
          f"layers, bf16 compute / fp32 master, remat, adamw, "
          f"{TRAINER_STEPS} steps over device_put_iterator of fresh seeded "
          f"int64 batches {TRAIN_BATCH} x {TRAIN_SEQ + 1}, Zipf over the "
          f"whole vocabulary, lr {TRAINER_LR}, warmup {TRAINER_WARMUP}; "
          f"losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    print(f"trainer: median step {med:.1f} ms (steps 2-{TRAINER_STEPS}, "
          f"from tokens_per_s; each "
          f"{[round(x, 1) for x in step_ms]}) beside the train phase's "
          f"bare step {train_stats['median_ms']:.1f} ms in this run; peak "
          f"memory {peak_gib:.2f} GiB (train phase "
          f"{train_stats['peak_gib']:.2f}); hbm_usage "
          f"{json.dumps(profiler.hbm_usage())} [{gpu_line}]", flush=True)
    n = cfg.n_layers * TRAINER_STEPS
    print(f"trainer: launches {json.dumps(launches)} (expected K1 2 x "
          f"{cfg.n_layers} x {TRAINER_STEPS}, K2a and K2b {cfg.n_layers} x "
          f"{TRAINER_STEPS})", flush=True)
    check(len(hist) == TRAINER_STEPS and hist[-1]["step"] == TRAINER_STEPS,
          f"trainer: {len(hist)} logged steps")
    check(all(map(math.isfinite, losses + norms)),
          "trainer: non-finite loss or grad_norm")
    check(losses[-1] < losses[0], f"trainer: loss did not fall: {losses}")
    check(launches == {"flash_fwd (K1)": 2 * n, "flash_bwd_dq (K2a)": n,
                       "flash_bwd_dkv (K2b)": n},
          f"trainer: unexpected launch counts {launches}")
    del res
    release(torch)

    # the trainer's step (its optimizer and schedule) on a loader batch
    feed = device_put_iterator(data())
    batch = next(feed)
    feed.close()
    tx = make_optimizer(tcfg.optimizer, schedule=warmup_cosine(
        tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps),
        grad_clip=tcfg.grad_clip)
    state, step = make_train_step(model, tx)(batch)
    timed = profiler.timed_steps(step, state, batch, warmup=1,
                                 iters=TRAINER_TIMED)
    print(f"trainer: profiler.timed_steps of the step: "
          f"{timed['mean_step_s'] * 1e3:.1f} ms a step, "
          f"{timed['steps_per_s']:.3f} steps/s ({TRAINER_TIMED} steps after "
          f"1 warm-up) [{gpu_line}]", flush=True)
    del state, step, timed, model, batch
    release(torch)

    # the witness: the same fit at the train phase's lr, in bf16 and in
    # fp32 compute; no check (PERF.md reads it)
    for dt in (torch.bfloat16, torch.float32):
        wcfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=dt,
                                     param_dtype=torch.float32)
        hist = fit(trainer_config(Llama(wcfg, device="cuda", seed=0),
                                  TRAINER_SPIKE_LR), "witness").metrics_history
        print(f"trainer: witness at lr {TRAINER_SPIKE_LR}, {dt} compute, "
              f"the same model and batches: losses "
              f"{[round(m['loss'], 4) for m in hist]}, grad_norm "
              f"{[round(m['grad_norm'], 3) for m in hist]}", flush=True)
        release(torch)
    return launches


class SimulatedCrash(Exception):
    """Raised by ResumeBatches in place of batch RESUME_CRASH_AT."""


class ResumeBatches:
    """Batch i is RandomState(100 + i)'s tokens; fast_forward(n) seeks so
    the next batch is batch n; every draw is logged; with `crash_at` the
    draw of that batch raises SimulatedCrash."""

    def __init__(self, log, vocab, crash_at=None):
        self.i, self.log, self.vocab, self.crash_at = 0, log, vocab, crash_at

    def __iter__(self):
        return self

    def __next__(self):
        import numpy as np
        if self.i == self.crash_at:
            raise SimulatedCrash(f"batch {self.i}")
        self.log.append(self.i)
        rng = np.random.RandomState(100 + self.i)
        self.i += 1
        return {"tokens": rng.randint(0, self.vocab, (2, 257))}

    def fast_forward(self, n):
        self.log.append(("ff", n))
        self.i = n


def phase_trainer_resume(torch):
    """SpmdTrainer's resume on the card at the flagship widths (bf16
    compute, fp32 master weights, adamw): a RESUME_STEPS-step fit whose
    source fails at batch RESUME_CRASH_AT (checkpoints every
    RESUME_EVERY steps; the same schedule as an uninterrupted run) is
    resumed from its last checkpoint with a fast_forward iterator, and
    held to an uninterrupted RESUME_STEPS-step run: the batches already
    consumed are never drawn again, and every step's loss is the
    uninterrupted run's (RESUME_RTOL)."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.train import (CheckpointManager, RunConfig,
                                     SpmdTrainer, SpmdTrainerConfig)

    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.bfloat16,
                      param_dtype=torch.float32)
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")

    def fit(name, log, crash_at=None, every=0, resume=None):
        rows = []
        tcfg = SpmdTrainerConfig(
            model=Llama(cfg, device="cuda", seed=0), total_steps=RESUME_STEPS,
            log_every=1, warmup_steps=1, learning_rate=1e-3,
            checkpoint_every=every, device="cuda")
        trainer = SpmdTrainer(
            tcfg, lambda: ResumeBatches(log, cfg.vocab_size, crash_at),
            run_config=RunConfig(name=name, storage_path=root),
            report_fn=rows.append)
        try:
            trainer.fit(resume_from=resume)
        except SimulatedCrash:
            pass
        return {m["step"]: m["loss"] for m in rows}

    try:
        crashed = fit("crashed", [], RESUME_CRASH_AT, RESUME_EVERY)
        ckpt = CheckpointManager(os.path.join(
            root, "crashed", "checkpoints")).latest()
        ckpt_step = ckpt.metadata()["step"] if ckpt is not None else None
        log = []
        resumed = fit("resumed", log, resume=ckpt.path)
        whole = fit("whole", [])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    drawn = [x for x in log if isinstance(x, int) and x > 0]
    pairs = [(s, x, whole[s]) for run in (crashed, resumed)
             for s, x in sorted(run.items())]
    bitwise = all(x == w for _, x, w in pairs)
    print(f"trainer-resume: flagship widths bf16/fp32, the first run failed "
          f"drawing batch {RESUME_CRASH_AT} after steps "
          f"{sorted(crashed)} (checkpoint {os.path.basename(ckpt.path)}); "
          f"resumed steps {sorted(resumed)}; the resumed run drew "
          f"{log} (batches 1-{RESUME_CRASH_AT - 1} never); losses vs the "
          f"uninterrupted run "
          f"{[(s, round(x, 7), round(w, 7)) for s, x, w in pairs]}, bit "
          f"for bit: {bitwise}", flush=True)
    check(sorted(crashed) == list(range(1, RESUME_CRASH_AT + 1)),
          f"trainer-resume: the crashed run logged {sorted(crashed)}")
    check(ckpt_step == RESUME_CRASH_AT,
          "trainer-resume: no checkpoint at the crash")
    check(sorted(resumed) == list(range(RESUME_CRASH_AT + 1,
                                        RESUME_STEPS + 1)),
          f"trainer-resume: the resumed run logged {sorted(resumed)}")
    check(log[0] == 0 and ("ff", RESUME_CRASH_AT) in log
          and drawn[:2] == [RESUME_CRASH_AT, RESUME_CRASH_AT + 1]
          and all(x >= RESUME_CRASH_AT for x in drawn),
          f"trainer-resume: the resumed run re-drew consumed batches: {log}")
    check(all(abs(x - w) <= RESUME_RTOL * abs(w) for _, x, w in pairs),
          "trainer-resume: a resumed step's loss differs from the "
          "uninterrupted run's")
    release(torch)


def phase_train_parity(torch):
    """fp32 train steps on the GPU (K1 + K2a/K2b, fp32 kernels) against
    the same model and batch on the CPU (einsum attention, no remat);
    then one GPU step under remat "dots" against the CPU's first."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.float32,
                      param_dtype=torch.float32)
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 257))
    cpu_model = Llama(cfg, device="cpu", seed=2)
    weights = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    results = {}
    for dev in ("cuda", "cpu"):
        model = cpu_model if dev == "cpu" else Llama(cfg, device="cuda",
                                                     seed=2)
        model.load_state_dict(weights)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1))(batch)
        zero_counters(fa)
        rows = []
        for _ in range(PARITY_STEPS):
            state, m = step(state, batch)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        results[dev] = (rows, read_counters(fa))
        del model, state, step
    (gpu, launches), (cpu, _) = results["cuda"], results["cpu"]
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        print(f"train-parity: step {i} loss gpu {g[0]:.7f} cpu {c[0]:.7f} "
              f"grad_norm gpu {g[1]:.7f} cpu {c[1]:.7f}", flush=True)
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for g, c in zip(gpu, cpu) for a, b in zip(g, c))
    print(f"train-parity: flagship widths fp32 (TF32 off), S=256, sgd; "
          f"rtol {PARITY_RTOL}: {ok}; GPU launches {json.dumps(launches)}",
          flush=True)
    check(ok, "GPU train steps differ from the CPU")
    check(all(n > 0 for n in launches.values()),
          f"the GPU steps did not run K1/K2a/K2b: {launches}")

    # remat "dots": selective checkpointing around the ctypes-launched
    # kernels; K1 runs in the forward and again in the recompute
    dots = Llama(dataclasses.replace(cfg, remat=True, remat_policy="dots"),
                 device="cuda", seed=2)
    dots.load_state_dict(weights)
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    state, step = make_train_step(dots, make_optimizer(
        "sgd", learning_rate=0.1))(batch)
    zero_counters(fa)
    _, m = step(state, batch)
    got = (float(m["loss"]), float(m["grad_norm"]))
    launches = read_counters(fa)
    n = cfg.n_layers
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b) for a, b in zip(got, cpu[0]))
    print(f"train-parity: remat dots, one step: loss gpu {got[0]:.7f} cpu "
          f"{cpu[0][0]:.7f} grad_norm gpu {got[1]:.7f} cpu {cpu[0][1]:.7f} "
          f"(rtol {PARITY_RTOL}: {ok}); launches {json.dumps(launches)} "
          f"(expected K1 2 x {n}, K2a and K2b {n})", flush=True)
    check(ok, "the remat dots step differs from the CPU")
    check(launches == {"flash_fwd (K1)": 2 * n, "flash_bwd_dq (K2a)": n,
                       "flash_bwd_dkv (K2b)": n},
          f"unexpected launch counts under remat dots: {launches}")
    del dots, state, step
    gc.collect()
    torch.cuda.empty_cache()


GRPO_LAYERS = 8           # depth cut of (a): full-parameter, 8B widths
GRPO_PROMPTS = 2          # prompts a step ...
GRPO_PLENS = (64, 224)    # ... of this many random tokens (inclusive)
GRPO_GROUP = 8
GRPO_NEW = 32
GRPO_STEPS = 2
GRPO_RANK = 8
# (a) takes GRPOConfig's default lr; (b) 1e-4, since a merge rounds the
# delta into the bf16 base: at 1e-5 the first step's delta (~7e-6) is
# below half a bf16 ulp of most base weights, the merged policy would not
# move and its KL would read 0
GRPO_LR_FULL, GRPO_LR_LORA = 1e-5, 1e-4
GRPO_PARITY_RTOL = 1e-4
# parity of the update's params: Adam steps an element by lr * g / (|g| +
# 1e-8), so an element whose gradient is at rounding level (below this,
# where the GPU's and the CPU's sums may differ in sign) may step by a
# different fraction of lr on each; those are counted and printed, every
# other element is held to rtol 1e-4 plus lr / 10
GRPO_GRAD_FLOOR = 1e-7


def grpo_reward(prompt_ids, completion_ids):
    """Counts target tokens, the ids divisible by 7: one target id would
    almost never come up in 32 draws over 128256 ids, every reward would
    be 0, and so would every advantage."""
    return float(sum(1 for t in completion_ids if int(t) % 7 == 0))


def grpo_engine_cfg(gcfg):
    """EngineSampler's default engine config plus kv_page_size=16: the
    paged engine, whose prefill runs K1 and decode K3."""
    from ray_tpu_torch.serve.llm import LLMEngineConfig
    return LLMEngineConfig(
        max_slots=min(16, max(2, gcfg.group_size)), max_seq_len=512,
        prefill_buckets=(16, 32, 64, 128, 256),
        max_new_tokens_default=gcfg.max_new_tokens,
        eos_token_id=CONTROLS_EOS, kv_page_size=16)


class CountingSampler:
    """A sampler that counts the K1 and K3 launches and the decode-graph
    replays made while it samples and keeps every completion it
    returned."""

    def __init__(self, sampler):
        from ray_tpu_torch.ops.kernels import flash_attention as fa
        from ray_tpu_torch.ops.kernels import paged_attention as pa
        self.sampler, self.fa, self.pa = sampler, fa, pa
        self.k1 = self.k3 = self.replays = 0
        self.tokens = []

    def __call__(self, prompt_ids, group):
        k1 = self.fa.flash_attention_fwd.launches
        k3 = self.pa.paged_decode_attention.launches
        replays = graph_replays()
        toks = self.sampler(prompt_ids, group)
        self.k1 += self.fa.flash_attention_fwd.launches - k1
        self.k3 += self.pa.paged_decode_attention.launches - k3
        self.replays += graph_replays() - replays
        self.tokens.append(toks)
        return toks

    def set_params(self, params):
        self.sampler.set_params(params)

    def shutdown(self):
        self.sampler.shutdown()


def grpo_run(torch, trainer, label, n_layers, vocab, gpu_line,
             after_step):
    """GRPO_STEPS steps of `trainer` on GRPO_PROMPTS random prompts.

    Launch counts, read over the steps (counters zeroed just before):
    sampling launches K1 (each prefill dispatch, a launch a layer) and K3
    (each decode step, a launch a layer), counted apart by
    CountingSampler; the learner launches, per layer and step, K1 2 for
    the old and the reference log-probs (no grad, no remat) plus 2 per
    epoch (the update's forward and its remat recompute), and K2a 1 and
    K2b 1 per epoch."""
    import numpy as np
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, vocab, rng.randint(GRPO_PLENS[0],
                                                 GRPO_PLENS[1] + 1)).tolist()
               for _ in range(GRPO_PROMPTS)]
    counting = CountingSampler(trainer.sampler)
    trainer.sampler = counting
    zero_counters(fa)
    pa.paged_decode_attention.launches = 0
    stats = []
    for i in range(GRPO_STEPS):
        st = trainer.step(prompts)
        torch.cuda.synchronize()
        t = trainer.timings
        print(f"{label}: step {i} prompts {[len(p) for p in prompts]} "
              f"sample {t['sample_s'] * 1e3:.1f} ms, log-probs "
              f"{t['logps_s'] * 1e3:.1f} ms, update {t['update_s'] * 1e3:.1f}"
              f" ms; " + ", ".join(f"{k} {v:.6g}" for k, v in st.items())
              + f" [{gpu_line}]", flush=True)
        after_step(i)
        stats.append(st)
    launches = read_counters(fa)
    launches["paged_decode (K3)"] = pa.paged_decode_attention.launches
    epochs, steps = trainer.cfg.num_epochs, GRPO_STEPS
    learner_k1 = launches["flash_fwd (K1)"] - counting.k1
    want_k1 = (2 + 2 * epochs) * n_layers * steps
    want_k2 = epochs * n_layers * steps
    print(f"{label}: launches {json.dumps(launches)}; sampling K1 "
          f"{counting.k1}, K3 {counting.k3}; learner K1 {learner_k1} "
          f"(expected (2 + 2 x {epochs}) x {n_layers} x {steps} = "
          f"{want_k1}), K2a/K2b expected {epochs} x {n_layers} x {steps} = "
          f"{want_k2}", flush=True)
    note_graphs(label, counting.sampler.engine.get_stats()["decode_graphs"],
                counting.replays)
    toks = np.concatenate([t.reshape(-1) for t in counting.tokens])
    check(((toks >= 0) & (toks < vocab)).all(),
          f"{label}: a sampled token is out of vocab")
    for st in stats:
        for k in ("total_loss", "pg_loss", "kl", "reward_mean"):
            check(math.isfinite(st[k]), f"{label}: non-finite {k}: {st}")
    check(stats[1]["kl"] > 0, f"{label}: kl is {stats[1]['kl']} after the "
                              f"first update: is the reference frozen?")
    check(counting.k1 > 0 and counting.k3 > 0
          and launches["paged_decode (K3)"] == counting.k3,
          f"{label}: sampling launched K1 {counting.k1}, K3 {counting.k3}")
    check(learner_k1 == want_k1
          and launches["flash_bwd_dq (K2a)"] == want_k2
          and launches["flash_bwd_dkv (K2b)"] == want_k2,
          f"{label}: unexpected learner launches {launches}")
    return launches


def grpo_full(torch, gpu_line):
    """(a) Full-parameter GRPO on the train phase's model (Llama-3-8B
    widths, GRPO_LAYERS layers, bf16 compute, fp32 params, remat): the
    engine sampler shares the learner's module, so after each step its
    weights are the learner's, the same tensors."""
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.rllib import EngineSampler, GRPOConfig, GRPOTrainer
    cfg = LlamaConfig.llama3_8b(n_layers=GRPO_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Llama(cfg, device="cuda", seed=0)
    gcfg = GRPOConfig(group_size=GRPO_GROUP, max_new_tokens=GRPO_NEW,
                      lr=GRPO_LR_FULL, temperature=1.0, seed=0)
    sampler = EngineSampler(model, None, gcfg, eos_id=CONTROLS_EOS,
                            engine_cfg=grpo_engine_cfg(gcfg))
    trainer = GRPOTrainer(model=model, reward_fn=grpo_reward, cfg=gcfg,
                          eos_id=CONTROLS_EOS, sampler=sampler,
                          device="cuda")
    engine = sampler.engine
    n = sum(p.numel() for p in model.parameters())
    print(f"grpo-full: Llama-3-8B widths, {cfg.n_layers} layers, "
          f"{n / 1e9:.3f}B params fp32 / bf16 compute, remat={cfg.remat}, "
          f"group {GRPO_GROUP}, {GRPO_NEW} new tokens, lr {GRPO_LR_FULL}, "
          f"paged engine; built in {time.time() - t0:.1f} s", flush=True)

    def same_weights(step):
        shared = all(engine.params[k].data_ptr() == p.data_ptr()
                     and torch.equal(engine.params[k], p)
                     for k, p in trainer.params.items())
        print(f"grpo-full: step {step}: engine weights are the learner's "
              f"(shared, bit for bit): {shared}", flush=True)
        check(shared, "the engine's weights differ from the learner's")

    try:
        launches = grpo_run(torch, trainer, "grpo-full", cfg.n_layers,
                            cfg.vocab_size, gpu_line, same_weights)
    finally:
        trainer.shutdown()
    peak = torch.cuda.max_memory_allocated()
    print(f"grpo-full: peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) [{gpu_line}]", flush=True)
    del trainer, sampler, engine, model
    release(torch)
    return launches


def grpo_lora(torch, gpu_line):
    """(b) LoRA GRPO over Llama-3-8B at full depth: a frozen bf16 base,
    rank GRPO_RANK adapters on DEFAULT_TARGETS; the engine samples on its
    own copy of the module, which holds merge_lora(base, adapters) after
    each step; the base stays bit-identical."""
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.rllib import GRPOConfig, make_lora_grpo_trainer
    from ray_tpu_torch.train import init_lora, lora_param_count
    from ray_tpu_torch.train.lora import lora_delta, unflatten_adapters
    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Llama(cfg, device="cuda", seed=0)
    base = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    lora = init_lora(model, 1, rank=GRPO_RANK)
    gcfg = GRPOConfig(group_size=GRPO_GROUP, max_new_tokens=GRPO_NEW,
                      lr=GRPO_LR_LORA, temperature=1.0, seed=0)
    trainer = make_lora_grpo_trainer(
        model, None, lora, grpo_reward, cfg=gcfg, eos_id=CONTROLS_EOS,
        engine_cfg=grpo_engine_cfg(gcfg), device="cuda")
    engine = trainer.sampler.engine
    scaling = lora["alpha"] / lora["rank"]
    print(f"grpo-lora: Llama-3-8B, {cfg.n_layers} layers, frozen bf16 base, "
          f"rank {GRPO_RANK} on {len(lora['adapters'])} weights "
          f"({lora_param_count(lora) / 1e6:.2f} M adapter params), lr "
          f"{GRPO_LR_LORA}, paged engine on its own copy; built in "
          f"{time.time() - t0:.1f} s", flush=True)

    def merged_weights(step):
        adapters = unflatten_adapters(trainer.params)
        ok = True
        with torch.no_grad():
            for name, p in model.named_parameters():
                want = p
                if name in adapters:
                    want = p + lora_delta(adapters[name], scaling, p.dtype)
                ok = ok and torch.equal(engine.params[name], want)
        print(f"grpo-lora: step {step}: engine weights equal merge_lora(base,"
              f" adapters) bit for bit: {ok}", flush=True)
        check(ok, "the engine's weights differ from the merge")

    try:
        launches = grpo_run(torch, trainer, "grpo-lora", cfg.n_layers,
                            cfg.vocab_size, gpu_line, merged_weights)
    finally:
        trainer.shutdown()
    peak = torch.cuda.max_memory_allocated()
    same = all(torch.equal(v.cpu(), base[k])
               for k, v in model.state_dict().items())
    print(f"grpo-lora: base bit-identical after {GRPO_STEPS} steps: {same}; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated) "
          f"[{gpu_line}]", flush=True)
    check(same, "the frozen base moved")
    del trainer, engine, model, base, lora
    release(torch)
    return launches


def grpo_parity_batch(np, vocab):
    """A fixed GRPO batch: 8 rows of a ragged 40 tokens, prompts of 8-20
    tokens, completions cut by EOS at random places and EOS-padded, the
    masks the trainer builds for them, right padding with 0."""
    rng = np.random.RandomState(11)
    rows, width = 8, 40
    tokens = np.zeros((rows, width), np.int64)
    mask = np.zeros((rows, width - 1), np.float32)
    eos = vocab - 1
    for r in range(rows):
        plen = rng.randint(8, 21)
        total = rng.randint(plen + 4, width + 1)
        tokens[r, :total] = rng.randint(0, vocab - 1, total)
        end = rng.randint(1, total - plen + 1)
        tokens[r, plen + end - 1:total] = eos
        mask[r, plen - 1:plen - 1 + end] = 1.0
    return {"tokens": tokens, "mask": mask,
            "advantages": rng.standard_normal(rows).astype(np.float32)}


def grpo_parity(torch):
    """(c) fp32 (TF32 off) at FLAGSHIP widths: one GRPOLearner.update,
    full-parameter and over LoRA adapters, on the GPU (K1/K2a/K2b fp32)
    against the same on the CPU, from the same weights and batch: the
    stats, the gradients, and the updated params."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.rllib import GRPOConfig, make_lora_grpo_trainer
    from ray_tpu_torch.rllib.grpo import GRPOLearner, module_apply
    from ray_tpu_torch.train import init_lora

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.float32,
                      param_dtype=torch.float32)
    gcfg = GRPOConfig(lr=1e-4, kl_coeff=0.1, grad_clip=1.0)
    cpu_model = Llama(cfg, device="cpu", seed=3)
    weights = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    batch = grpo_parity_batch(np, cfg.vocab_size)
    with torch.no_grad():
        start = GRPOLearner(module_apply(cpu_model), dict(
            cpu_model.named_parameters()), gcfg).token_logps(
            dict(cpu_model.named_parameters()), batch["tokens"])
    rng = np.random.RandomState(12)
    batch["old_logps"] = (start + 0.2 * rng.standard_normal(start.shape)
                          ).astype(np.float32)
    batch["ref_logps"] = (start + 0.1 * rng.standard_normal(start.shape)
                          ).astype(np.float32)
    lora = init_lora(cpu_model, 4, rank=8)
    gen = torch.Generator().manual_seed(5)
    for pair in lora["adapters"].values():
        pair["B"] = torch.randn(pair["B"].shape, generator=gen) * 0.01

    def learner_for(kind, dev):
        model = Llama(cfg, device=dev, seed=3)
        model.load_state_dict(weights)
        if kind == "full":
            return GRPOLearner(module_apply(model), dict(
                model.named_parameters()), gcfg), None
        dl = {**lora, "adapters": {k: {n: t.to(dev) for n, t in p.items()}
                                   for k, p in lora["adapters"].items()}}
        tr = make_lora_grpo_trainer(model, None, dl, None, cfg=gcfg,
                                    max_seq_len=64, device=dev)
        return tr.learner, tr.sampler

    for kind in ("full", "lora"):
        res = {}
        for dev in ("cuda", "cpu"):
            learner, sampler = learner_for(kind, dev)
            zero_counters(fa)
            loss, _ = learner.loss(learner._tensors(batch))
            loss.backward()
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in learner.params.items()}
            for p in learner.params.values():
                p.grad = None
            stats = learner.update(batch)
            params = {k: p.detach().cpu().clone()
                      for k, p in learner.params.items()}
            res[dev] = (stats, grads, params, read_counters(fa))
            if sampler is not None:
                sampler.shutdown()
            del learner, sampler
        (gs, gg, gp, launches), (cs, cg, cp, _) = res["cuda"], res["cpu"]
        for k in cs:
            print(f"grpo-parity: {kind} {k} gpu {gs[k]:.8g} cpu {cs[k]:.8g}",
                  flush=True)
        ok_stats = all(abs(gs[k] - cs[k]) <= GRPO_PARITY_RTOL * abs(cs[k])
                       for k in cs)
        ok_grads = all(bool(((gg[k] - cg[k]).abs() <= GRPO_PARITY_RTOL
                             * cg[k].abs() + 1e-5 * cg[k].abs().max()).all())
                       for k in cg)
        bad = low = 0
        for k in cp:
            off = (gp[k] - cp[k]).abs() > (GRPO_PARITY_RTOL * cp[k].abs()
                                           + gcfg.lr / 10)
            floor = (cg[k].abs() <= GRPO_GRAD_FLOOR) & (cg[k] != 0)
            bad += int((off & ~floor).sum())
            low += int(floor.sum())
        n = sum(v.numel() for v in cp.values())
        print(f"grpo-parity: {kind}: stats rtol {GRPO_PARITY_RTOL}: "
              f"{ok_stats}; gradients rtol {GRPO_PARITY_RTOL} (+1e-5 of each tensor's "
              f"largest): {ok_grads}; updated params rtol "
              f"{GRPO_PARITY_RTOL} + lr/10: {bad} of {n} off ({low} with "
              f"0 < |grad| <= {GRPO_GRAD_FLOOR} not held); GPU launches "
              f"{json.dumps(launches)}", flush=True)
        check(ok_stats and ok_grads and bad == 0,
              f"the GPU's {kind} GRPO update differs from the CPU's")
        check(all(v > 0 for v in launches.values()),
              f"the GPU's {kind} update did not run K1/K2a/K2b: {launches}")
    release(torch)


def phase_grpo(torch, gpu_line):
    """Post-training: (a) full-parameter GRPO at 8B widths, (b) LoRA GRPO
    over the full-depth 8B, (c) the update's fp32 parity with the CPU."""
    launches = {"grpo-full": grpo_full(torch, gpu_line),
                "grpo-lora": grpo_lora(torch, gpu_line)}
    grpo_parity(torch)
    return launches


def phase_north_star(torch):
    """Pretrain the flagship widths on a repeating corpus, checkpoint
    through CheckpointManager, restore, serve the restored weights
    through LLMServer on the paged engine, then GRPO post-train the
    restored model through the engine sampler (tests/test_north_star.py
    stages 1-4; stage 4 with the reference test's reward and settings, on
    EngineSampler's default contiguous engine). Returns stage 4's
    K1/K2a/K2b launches."""
    import shutil
    import tempfile

    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.rllib import GRPOConfig, GRPOTrainer
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.train import (CheckpointManager, make_optimizer,
                                     make_train_step, restore_pytree)

    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.bfloat16,
                      param_dtype=torch.float32)
    corpus = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": torch.from_numpy(corpus).to("cuda")}
    model = Llama(cfg, device="cuda", seed=0)
    state, step = make_train_step(model, make_optimizer(
        "adamw", learning_rate=5e-3))(batch)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    print(f"north-star: losses {[round(x, 4) for x in losses]}", flush=True)
    check(losses[-1] < losses[0] - 0.3, f"pretrain loss did not fall: "
                                        f"{losses}")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(root)
        mgr.save(model.state_dict(), state.step)
        ckpt = mgr.latest()
        check(ckpt is not None and ckpt.metadata()["step"] == 15,
              "no committed checkpoint")
        restored = restore_pytree(ckpt.as_directory(), map_location="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state, step, model
    server = LLMServer(
        lambda: (Llama(cfg, device="cuda", seed=99), restored),
        engine_config=dict(max_slots=2, max_seq_len=64, kv_page_size=16,
                           prefill_buckets=(16,)), device="cuda")
    try:
        toks = server({"prompt": corpus[0, :8].tolist(),
                       "max_tokens": 6})["tokens"]
    finally:
        server.shutdown()
    truth = corpus[0, 8:14].tolist()
    hits = sum(int(t == u) for t, u in zip(toks, truth))
    print(f"north-star: restored checkpoint served greedy {toks}, corpus "
          f"{truth}, {hits}/6 match", flush=True)
    check(len(toks) == 6 and hits >= 1,
          "the served checkpoint does not continue the corpus")
    del server

    target = int(corpus[0, 0])

    def reward(prompt_ids, completion_ids):
        return float(sum(1 for t in completion_ids if t == target))

    zero_counters(fa)
    trainer = GRPOTrainer(params=restored, reward_fn=reward,
                          model=Llama(cfg, device="cuda", seed=98),
                          max_seq_len=64,
                          cfg=GRPOConfig(group_size=4, max_new_tokens=8,
                                         lr=5e-3, temperature=1.0),
                          device="cuda")
    try:
        stats = [trainer.step([corpus[0, :8].tolist()]) for _ in range(6)]
    finally:
        trainer.shutdown()
    launches = read_counters(fa)
    early = statistics.mean(s["reward_mean"] for s in stats[:2])
    late = statistics.mean(s["reward_mean"] for s in stats[-2:])
    print(f"north-star: GRPO through the engine sampler, 6 steps: reward "
          f"{[s['reward_mean'] for s in stats]}, total_loss "
          f"{[round(s['total_loss'], 5) for s in stats]}; early {early:.3f}"
          f" late {late:.3f}; launches {json.dumps(launches)}", flush=True)
    check(late >= early - 0.5, f"GRPO moved the reward the wrong way: "
                               f"{early} -> {late}")
    check(all(math.isfinite(s["total_loss"]) for s in stats),
          "non-finite GRPO loss")
    check(launches["flash_bwd_dq (K2a)"] > 0,
          f"the GRPO update did not run K1/K2a/K2b: {launches}")
    del trainer, restored
    gc.collect()
    torch.cuda.empty_cache()
    return launches


PARALLEL_STEPS = 5        # (a): the train phase's steps and schedule
PARALLEL_PARITY_STEPS = 2
PARALLEL_ATOL = 1e-6      # (b): params near zero, beside rtol PARITY_RTOL
RING_SHAPE = (1, 2048, 32, 8, 128)   # (c): B, S, Hq, Hkv, D, bf16, causal
PARALLEL_PLENS = (17, 60, 100, 200)  # (d): the served burst's prompts


def mesh_train_rank(n_layers, steps, rows, profile, gpu_line):
    """(a) on this rank: the train phase's model and schedule under
    MeshSpec(fsdp=world) (FSDP2, fp32 master weights and all-gather),
    `rows` rows of TRAIN_SEQ + 1 tokens from seed 0, the same on every
    rank (each trains on its share). Returns losses, grad norms, step
    times, K1/K2a/K2b launches and peak memory."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     warmup_cosine)
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(fsdp=n), device="cuda")
    cfg = LlamaConfig.llama3_8b(n_layers=n_layers, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, TRAIN_SEQ + 1),
                                     device="cuda", generator=gen)}
    tx = make_optimizer("adamw", schedule=warmup_cosine(3e-4, 1, steps))
    state, step = make_train_step(model, tx, mesh)(batch)
    torch.cuda.synchronize()
    zero_counters(fa)
    losses, norms, times = [], [], []
    for _ in range(steps):
        t1 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = read_counters(fa)
    peak = torch.cuda.max_memory_allocated()
    if profile:
        gpu_profile(torch, lambda: step(state, batch),
                    "parallel-train-profile", gpu_line, top=12)
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms, "times": times,
            "launches": launches, "peak_gib": peak / 2**30}


def mesh_parity_rank(rows, path):
    """(b) and (d) on this rank. (b) PARALLEL_PARITY_STEPS fp32 sgd steps
    of the flagship widths under MeshSpec(fsdp=world) against the same
    steps of the single-device make_train_step on rank 0's card (TF32
    off): loss, grad_norm and params. (d) the mesh model's state saved
    sharded to `path`, restored onto the mesh (shardings: each rank's
    shards cut on the host, the card's memory rising by no more than
    this rank's shards plus the largest leaf) and on rank 0 onto one
    device (shardings None), both equal to the trained params bit for
    bit, then served by the paged engine: greedy tokens equal to the
    einsum loop's."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     prepare_module, restore_pytree,
                                     save_pytree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(fsdp=n), device="cuda")
    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.float32,
                      param_dtype=torch.float32)
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (rows, 257))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    sharded = Llama(cfg, device="cuda", seed=2)
    state, step = make_train_step(sharded, make_optimizer(
        "sgd", learning_rate=0.1), mesh)(batch)
    rows_mesh = []
    for _ in range(PARALLEL_PARITY_STEPS):
        state, m = step(state, batch)
        rows_mesh.append((float(m["loss"]), float(m["grad_norm"])))
    trained = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
               .detach().clone() for k, v in sharded.state_dict().items()}
    save_pytree(sharded.state_dict(), path, step=PARALLEL_PARITY_STEPS)
    # restored onto the mesh shard by shard: the rise of the card's
    # memory, against this rank's shards plus the largest leaf
    target = prepare_module(Llama(cfg, device="cuda", seed=98), mesh)
    layout = target.state_dict()
    shard_bytes = sum((v.to_local() if isinstance(v, DTensor) else v)
                      .numel() * v.element_size() for v in layout.values())
    largest = max(v.numel() * v.element_size() for v in layout.values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    restore_pytree(path, target=target, shardings=layout,
                   map_location="cuda")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    mesh_equal = all(torch.equal(
        v.full_tensor() if isinstance(v, DTensor) else v, trained[k])
        for k, v in target.state_dict().items())
    del target, layout
    if dist.get_rank() != 0:
        return None
    single = Llama(cfg, device="cuda", seed=2)
    sstate, sstep = make_train_step(single, make_optimizer(
        "sgd", learning_rate=0.1))(batch)
    rows_single = []
    for _ in range(PARALLEL_PARITY_STEPS):
        sstate, m = sstep(sstate, batch)
        rows_single.append((float(m["loss"]), float(m["grad_norm"])))
    worst = 0.0
    for k, v in single.state_dict().items():
        err = (trained[k] - v).abs() - PARALLEL_ATOL
        worst = max(worst, float((err / v.abs().clamp(min=1e-30)).max()))
    restored = restore_pytree(path, map_location="cuda")
    bitwise = all(torch.equal(restored[k], trained[k]) for k in trained)
    served = Llama(cfg, device="cuda", seed=99)
    served.load_state_dict(restored)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, k).tolist()
               for k in PARALLEL_PLENS]
    want = plain_greedy(torch, served, prompts)
    engine_parity(torch, served, prompts, want, "parallel-serve",
                  [("paged", dict(kv_page_size=16))],
                  dict(max_slots=4, max_seq_len=512,
                       prefill_buckets=(32, 64, 128, 256)))
    return {"mesh": rows_mesh, "single": rows_single, "worst_rel": worst,
            "bitwise": bitwise, "n_tensors": len(trained),
            "mesh_equal": mesh_equal, "restore_rise": rise,
            "restore_bound": shard_bytes + largest,
            "shard_bytes": shard_bytes, "largest": largest}


MOE_AUX_LAYERS = 2        # (f): Mixtral-8x7B widths in fp32
MOE_AUX_ROWS, MOE_AUX_SEQ = 2, 256   # rows a rank, tokens a row
MOE_AUX_RTOL = 1e-5


def moe_aux_rank():
    """(f) on this rank: Mixtral-8x7B widths at MOE_AUX_LAYERS fp32
    layers (TF32 off, the published capacity factor), each layer's
    router loss of one forward of a global batch of MOE_AUX_ROWS x world
    rows on one device, then of this rank's rows after shard_module on
    MeshSpec(ep=world): the global batch's values on every rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import Mixtral, MixtralConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import batch_sharding, shard_module
    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(ep=n), device="cuda")
    cfg = MixtralConfig.mixtral_8x7b(n_layers=MOE_AUX_LAYERS,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32, remat=False)
    model = Mixtral(cfg, device="cuda", seed=7)
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (MOE_AUX_ROWS * n, MOE_AUX_SEQ))).to("cuda")
    with torch.no_grad():
        model(tokens)
        single = [float(b.moe.router_loss) for b in model.blocks]
        shard_module(model, mesh)
        model(batch_sharding(mesh).shard(tokens))
        on_mesh = [float(b.moe.router_loss) for b in model.blocks]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"single": single, "mesh": on_mesh}


def moe_aux_check(aux, n):
    """(f): every rank's aux losses against one device's."""
    worst = max(abs(m - s_) / abs(s_) for r in aux
                for m, s_ in zip(r["mesh"], r["single"]))
    print(f"parallel: (f) Mixtral-8x7B widths, {MOE_AUX_LAYERS} fp32 layers "
          f"(TF32 off), MeshSpec(ep={n}), {MOE_AUX_ROWS * n} x "
          f"{MOE_AUX_SEQ} tokens: each layer's aux loss on the mesh "
          f"{[[round(x, 9) for x in r['mesh']] for r in aux]} (rank by "
          f"rank) vs one device {[round(x, 9) for x in aux[0]['single']]}, "
          f"worst relative error over the ranks {worst:.3g} (allowed "
          f"{MOE_AUX_RTOL})", flush=True)
    check(worst <= MOE_AUX_RTOL, "parallel (f): the MoE aux losses on the "
                                 "mesh differ from the global batch's")


def ring_rank():
    """(c) on this rank: ring_attention over MeshSpec(sp=world) at
    RING_SHAPE, bf16, causal, this rank's sequence chunk, against
    multi_head_attention of the whole sequence on the card (K1 on
    CUDA). Returns the largest error over the K1 tolerance's allowance
    (<= 1 passes) and K1's launches in the ring call."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.ops import multi_head_attention, ring_attention
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(sp=n), device="cuda")
    b, s, hq, hkv, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((b, s, h, d), device="cuda", generator=gen,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    r, c = mesh.get_local_rank("sp"), s // n
    chunk = slice(r * c, (r + 1) * c)
    with torch.no_grad():
        zero_counters(fa)
        got = ring_attention(q[:, chunk].contiguous(),
                             k[:, chunk].contiguous(),
                             v[:, chunk].contiguous(), mesh=mesh)
        torch.cuda.synchronize()
        k1 = fa.flash_attention_fwd.launches
        want = multi_head_attention(q, k, v, causal=True)[:, chunk]
    err = (got.float() - want.float()).abs()
    allowed = K1_ATOL_OUT + K1_RTOL_OUT * want.float().abs()
    return {"ratio": float((err / allowed).max()),
            "max_abs_err": float(err.max()), "k1": k1,
            "equal": bool(torch.equal(got, want))}


def phase_parallel(torch, gpu_line, train_stats):
    """The parallelism slice on this machine's n = device_count cards
    (one rank a card; at n == 1 a world of one NCCL rank in this
    process): (a) the train phase's model on MeshSpec(fsdp=n) at
    min(32, 8 n) layers, (b) fp32 mesh-vs-single parity, (c) ring
    attention at sp = n, (d) a sharded checkpoint restored onto the mesh
    and onto one device and served, (e) dryrun_multichip(n), (f) the MoE
    aux losses on MeshSpec(ep=n). Returns (a)'s launches
    (rank 0's; every rank's are checked) and its median step in ms."""
    import shutil
    import tempfile

    from ray_tpu_torch.entry import dryrun_multichip
    from ray_tpu_torch.train.backend import launch
    n = torch.cuda.device_count()
    spawn = n > 1

    def run(fn, *args):
        return launch(fn, n, "cuda", *args, timeout_s=900, spawn=spawn)

    layers = min(32, TRAIN_LAYERS * n)
    out = run(mesh_train_rank, layers, PARALLEL_STEPS, TRAIN_BATCH * n,
              not spawn, gpu_line)
    r0 = out[0]
    med = statistics.median(r0["times"][1:])
    print(f"parallel: (a) Llama-3-8B widths, {layers} layers, MeshSpec(fsdp="
          f"{n}) on {n} card(s), fp32 master weights and all-gather, bf16 "
          f"compute, remat, adamw; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
          f"rank; losses {[round(x, 6) for x in r0['losses']]} (train "
          f"phase: {[round(x, 6) for x in train_stats['losses']]})",
          flush=True)
    print(f"parallel: (a) median step {med * 1e3:.1f} ms (steps 1-"
          f"{PARALLEL_STEPS - 1}), {TRAIN_BATCH * n * TRAIN_SEQ / med:.1f} "
          f"tokens/s, peak memory rank 0 {r0['peak_gib']:.2f} GiB; the "
          f"train phase (no mesh, {TRAIN_LAYERS} layers, same run): median "
          f"{train_stats['median_ms']:.1f} ms, peak "
          f"{train_stats['peak_gib']:.2f} GiB [{gpu_line}]", flush=True)
    want = layers * PARALLEL_STEPS
    for rank, o in enumerate(out):
        check(all(map(math.isfinite, o["losses"] + o["norms"])),
              f"parallel (a): rank {rank}: non-finite loss or grad_norm")
        check(o["losses"][-1] < o["losses"][0],
              f"parallel (a): rank {rank}: loss did not fall {o['losses']}")
        check(o["launches"] == {"flash_fwd (K1)": 2 * want,
                                "flash_bwd_dq (K2a)": want,
                                "flash_bwd_dkv (K2b)": want},
              f"parallel (a): rank {rank}: launches {o['launches']}")
    print(f"parallel: (a) launches per rank {json.dumps(r0['launches'])} "
          f"(expected K1 2 x {layers} x {PARALLEL_STEPS}, K2a and K2b "
          f"{layers} x {PARALLEL_STEPS}) on all {n} rank(s)", flush=True)

    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        par = run(mesh_parity_rank, 2 * n,
                  os.path.join(root, "sharded"))[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for i, (g, c) in enumerate(zip(par["mesh"], par["single"])):
        print(f"parallel: (b) step {i} loss mesh {g[0]:.7f} single "
              f"{c[0]:.7f} grad_norm mesh {g[1]:.7f} single {c[1]:.7f}",
              flush=True)
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for g, c in zip(par["mesh"], par["single"])
             for a, b in zip(g, c))
    print(f"parallel: (b) flagship widths fp32 (TF32 off), MeshSpec(fsdp="
          f"{n}) vs one device, {PARALLEL_PARITY_STEPS} sgd steps: metrics "
          f"within rtol {PARITY_RTOL}: {ok}; params: worst |err| - "
          f"{PARALLEL_ATOL} over |single| = {par['worst_rel']:.3g}",
          flush=True)
    check(ok, "parallel (b): the mesh step's metrics differ from one "
              "device's")
    check(par["worst_rel"] <= PARITY_RTOL,
          "parallel (b): the mesh step's params differ from one device's")
    print(f"parallel: (d) sharded checkpoint of {par['n_tensors']} tensors "
          f"restored onto one device bit for bit: {par['bitwise']}; its "
          f"paged burst equal to the einsum loop (above)", flush=True)
    print(f"parallel: (d) restored onto MeshSpec(fsdp={n}) with shardings "
          f"bit for bit: {par['mesh_equal']}; rank 0's memory rose "
          f"{par['restore_rise']} B during the restore, bound "
          f"{par['restore_bound']} B (its shards {par['shard_bytes']} B + "
          f"the largest leaf {par['largest']} B)", flush=True)
    check(par["bitwise"], "parallel (d): the restored checkpoint differs "
                          "from the trained params")
    check(par["mesh_equal"], "parallel (d): the mesh restore differs from "
                             "the trained params")
    check(par["restore_rise"] <= par["restore_bound"],
          "parallel (d): the mesh restore took more card memory than this "
          "rank's shards plus the largest leaf")
    if n == 1:
        print("parallel: n == 1: this rank's shards are the whole tree and "
              "the data mesh is one rank, so (d)'s memory bound also holds "
              "for a restore that loads the whole tree, and (f) reduces "
              "nothing: neither can fail here, and passing is no evidence "
              "of the repairs they check on more cards", flush=True)

    moe_aux_check(run(moe_aux_rank), n)

    ring = run(ring_rank)
    worst = max(r["ratio"] for r in ring)
    print(f"parallel: (c) ring attention at sp={n}, B S Hq Hkv D = "
          f"{RING_SHAPE} bf16 causal vs multi_head_attention: max abs err "
          f"{max(r['max_abs_err'] for r in ring):.3g}, worst err / "
          f"allowance {worst:.3f}, bit-identical {ring[0]['equal']}; K1 "
          f"launches in the ring call {ring[0]['k1']}", flush=True)
    check(worst <= 1.0, "parallel (c): ring attention differs from "
                        "multi_head_attention")
    if n == 1:
        check(ring[0]["k1"] == 1 and ring[0]["equal"],
              "parallel (c): at sp 1 ring attention must be "
              "multi_head_attention (K1)")

    t0 = time.time()
    lines = dryrun_multichip(n, device="cuda")
    check(len(lines) == 6, f"parallel (e): {len(lines)} dry-run stages")
    print(f"parallel: (e) dryrun_multichip({n}) on CUDA: all 6 stages in "
          f"{time.time() - t0:.1f} s", flush=True)
    return r0["launches"], med * 1e3


# the runtime phase: a chain of bf16 tensors of 64 MiB each on the card;
# TorchTrainer's rank actor against the in-process train phase and the
# elastic gang's resumed steps against an uninterrupted fit, both the
# same code on the same card from the same seed (bit for bit expected;
# the check allows RUNTIME_RTOL of a loss, a cuBLAS heuristic of a fresh
# process picking another algorithm)
RUNTIME_CHAIN_ELEMS = 32 * 2**20
RUNTIME_RTOL = 1e-5
ELASTIC_STEPS = 8          # the elastic fit's steps at the flagship widths,
ELASTIC_EVERY = 2          # ... its checkpoints (the rank is killed once
ELASTIC_KILL_AT = 4        # ... this step's is committed: its second)
ELASTIC_ROWS, ELASTIC_SEQ = 2, 256
ELASTIC_DELAY_S = 0.5      # each batch's draw: paces the fit for the kill


class RuntimeProbe:
    """The runtime phase's GPU actor (made remote with num_gpus=1)."""

    def info(self):
        import torch
        from ray_tpu_torch import get_gpu_ids
        return {"gpu_ids": get_gpu_ids(), "cuda": torch.cuda.is_available(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "count": torch.cuda.device_count(), "pid": os.getpid()}

    def make(self, n, seed):
        import torch
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(n, device="cuda", dtype=torch.bfloat16,
                           generator=gen)

    def double(self, x):
        check(x.is_cuda, "a chained tensor left the card")
        return x * 2

    def counters(self):
        from ray_tpu_torch.core import device_store
        return dict(device_store.COUNTERS)


def cpu_probe():
    """A task without GPU resources: it must see no card."""
    import torch
    return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_available()


def runtime_train_loop(config):
    """TorchTrainer's loop in its rank actor: the train phase's model
    (seed 0), batch, optimizer and steps, each step timed to a
    synchronize and reported; K1/K2a/K2b zeroed just before the steps
    and read just after, with the actor's peak memory."""
    import torch
    from ray_tpu_torch import get_gpu_ids
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import (make_optimizer, make_train_step, report,
                                     warmup_cosine)
    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     device="cuda", generator=gen)}
    tx = make_optimizer("adamw", schedule=warmup_cosine(3e-4, 1,
                                                        TRAIN_STEPS))
    state, step = make_train_step(model, tx)(batch)
    torch.cuda.synchronize()
    zero_counters(fa)
    for i in range(TRAIN_STEPS):
        t1 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        t2 = time.time()
        report({"step": i + 1, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "step_ms": (t2 - t1) * 1e3, "t_end": t2})
    report({"launches": read_counters(fa), "layers": cfg.n_layers,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "gpu_ids": get_gpu_ids(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def paced_batches(rows, seq, seed, vocab, delay_s):
    """trainer_batches, each batch after delay_s seconds."""
    for b in trainer_batches(rows, seq, seed, vocab):
        time.sleep(delay_s)
        yield b


def rank_pids():
    """{actor_id: worker pid} of the ALIVE rank actors of a gang."""
    from ray_tpu_torch.util import state as state_api
    rows = state_api.list_actors(
        filters=[("class_name", "=", "_SpmdHost"), ("state", "=", "ALIVE")],
        limit=100)
    by_wid = {w["worker_id"]: w["pid"]
              for w in state_api.list_workers(limit=1000)}
    return {r["actor_id"]: by_wid[r["worker_id"]] for r in rows
            if r["worker_id"] in by_wid}


def runtime_resources(torch, rt):
    """(a): the GPU resource, a num_gpus=1 actor's card, a CPU task."""
    n = torch.cuda.device_count()
    res = rt.cluster_resources()
    probe = rt.remote(num_gpus=1)(RuntimeProbe).remote()
    info = rt.get(probe.info.remote(), timeout=300)
    cpu = rt.get(rt.remote(cpu_probe).remote(), timeout=300)
    print(f"runtime (a): cluster GPU {res.get('GPU')} of {n} cards; the "
          f"num_gpus=1 actor: get_gpu_ids {info['gpu_ids']}, "
          f"CUDA_VISIBLE_DEVICES {info['visible']!r}, cuda available "
          f"{info['cuda']} ({info['count']} card); a CPU task: "
          f"CUDA_VISIBLE_DEVICES {cpu[0]!r}, cuda available {cpu[1]}",
          flush=True)
    check(res.get("GPU") == n, f"runtime (a): GPU resource {res}")
    check(info["gpu_ids"] == [0] and info["cuda"] and info["count"] == 1
          and info["visible"] == "0", f"runtime (a): the GPU actor {info}")
    check(cpu == ("", False), f"runtime (a): the CPU task saw {cpu}")
    return probe


def runtime_device_objects(torch, rt, probe):
    """(b): a chain of bf16 CUDA tensors on one actor stays on the card;
    the driver's get copies the last one out once."""
    n = RUNTIME_CHAIN_ELEMS
    r1 = probe.make.remote(n, 0)
    r3 = probe.double.remote(probe.double.remote(r1))
    ready, _ = rt.wait([r3], timeout=300)
    before = rt.get(probe.counters.remote(), timeout=60)
    t0 = time.time()
    got = rt.get(r3, timeout=300)
    t_get = time.time() - t0
    after = rt.get(probe.counters.remote(), timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = torch.randn(n, device="cuda", dtype=torch.bfloat16,
                       generator=gen) * 2 * 2
    same = bool(got.device.type == "cuda" and got.dtype == want.dtype
                and torch.equal(got, want))
    print(f"runtime (b): 3 bf16 tensors of {n * 2 / 2**20:.0f} MiB on the "
          f"actor, 2 edges: counters before the driver's get {before}, "
          f"after {after}; the driver's get {t_get * 1e3:.1f} ms, on "
          f"{got.device}, bit for bit {same}", flush=True)
    check(ready == [r3] and before == {"kept_device": 3, "device_hits": 2,
                                       "materialized": 0},
          f"runtime (b): the chain left the card: {before}")
    check(after["materialized"] == 1, f"runtime (b): {after}")
    check(same, "runtime (b): the driver's copy differs from the actor's")
    del got, want
    rt.kill(probe)


def runtime_trainer(torch, rt, root, gpu_line, train_stats):
    """(c): TorchTrainer, one rank actor with num_gpus=1, on the train
    phase's model: K1/K2a/K2b launches and losses against the train
    phase's, the step time beside the in-process step's."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    t0 = time.time()
    res = TorchTrainer(runtime_train_loop,
                       scaling_config=ScalingConfig(num_workers=1),
                       run_config=RunConfig(name="torch_trainer",
                                            storage_path=root)).fit()
    t_fit = time.time() - t0
    check(res.error is None, f"runtime (c): TorchTrainer failed: "
          f"{res.error!r}")
    steps = [m for m in res.metrics_history if "loss" in m]
    final = [m for m in res.metrics_history if "launches" in m][-1]
    losses = [m["loss"] for m in steps]
    want = train_stats["losses"]
    rel = max(abs(x - w) / abs(w) for x, w in zip(losses, want))
    med = statistics.median(m["step_ms"] for m in steps[1:])
    n = final["layers"] * TRAIN_STEPS
    print(f"runtime (c): TorchTrainer, one rank actor (get_gpu_ids "
          f"{final['gpu_ids']}, CUDA_VISIBLE_DEVICES "
          f"{final['visible']!r}): losses {[round(x, 6) for x in losses]} "
          f"against the train phase's {[round(x, 6) for x in want]}, max "
          f"relative difference {rel:.3g} (bit for bit {losses == want}); "
          f"median step {med:.1f} ms against the in-process "
          f"{train_stats['median_ms']:.1f} ms; peak memory "
          f"{final['peak_gib']:.2f} GiB against {train_stats['peak_gib']:.2f}"
          f"; spawn to the first step's end "
          f"{steps[0]['t_end'] - t0:.1f} s, fit {t_fit:.1f} s; launches "
          f"{json.dumps(final['launches'])} [{gpu_line}]", flush=True)
    check(len(losses) == TRAIN_STEPS and rel <= RUNTIME_RTOL,
          "runtime (c): the rank actor's losses differ from the train "
          "phase's")
    check(final["launches"] == {"flash_fwd (K1)": 2 * n,
                                "flash_bwd_dq (K2a)": n,
                                "flash_bwd_dkv (K2b)": n},
          f"runtime (c): unexpected launch counts {final['launches']}")
    return final["launches"], med


def runtime_elastic(torch, rt, handle, root, gpu_line):
    """(d): ElasticSpmdTrainer at world 1 on the flagship widths: the
    rank is killed once its second checkpoint is committed, the gang
    reforms at full size once the dead process has exited (its card
    memory free), restores, and every later loss equals an uninterrupted
    fit's."""
    import functools
    import signal

    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.train import (ElasticSpmdTrainer, RunConfig,
                                     SpmdTrainer, SpmdTrainerConfig)
    from ray_tpu_torch.train.checkpoint import is_committed

    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.bfloat16,
                      param_dtype=torch.float32)

    def tcfg():
        return SpmdTrainerConfig(
            model=Llama(cfg, device="cuda", seed=0),
            total_steps=ELASTIC_STEPS, log_every=1, warmup_steps=1,
            learning_rate=1e-3, checkpoint_every=ELASTIC_EVERY,
            device="cuda")

    def data(delay_s):
        return functools.partial(paced_batches, ELASTIC_ROWS, ELASTIC_SEQ,
                                 0, cfg.vocab_size, delay_s)

    run_config = RunConfig(name="elastic", storage_path=root)
    trace = os.path.join(root, "elastic-trace")
    # the default resources: one CPU and one GPU a rank
    trainer = ElasticSpmdTrainer(
        tcfg(), data(ELASTIC_DELAY_S), num_hosts=1, run_config=run_config,
        env_per_host={"RAY_TPU_ELASTIC_TRACE": trace})
    box = {}

    def run():
        try:
            box["res"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 - checked below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    t0 = time.time()
    th.start()
    ckpt = os.path.join(run_config.run_dir(), "checkpoints",
                        f"checkpoint_{ELASTIC_KILL_AT:09d}")
    deadline = time.time() + 600
    while not is_committed(ckpt) and "err" not in box:
        check(time.time() < deadline, "runtime (d): no second checkpoint")
        time.sleep(0.02)
    check("err" not in box, f"runtime (d): the fit failed before the "
          f"kill: {box.get('err')!r}")
    pids = rank_pids()
    check(len(pids) == 1, f"runtime (d): rank actors {pids}")
    t_kill = time.time()
    os.kill(next(iter(pids.values())), signal.SIGKILL)
    th.join(900)
    check(not th.is_alive(), "runtime (d): the elastic fit never finished")
    check("err" not in box, f"runtime (d): {box.get('err')!r}")
    res = box["res"]
    t_end = time.time()
    handle.drain_local_events()
    reforms = handle.cluster_events.query(types=["train.gang.reform"],
                                          limit=10)[0]
    reform_s = float(reforms[-1]["attrs"]["seconds"]) if reforms else None
    whole = SpmdTrainer(tcfg(), data(0.0), run_config=RunConfig(
        name="whole", storage_path=root)).fit()
    want = {m["step"]: m["loss"] for m in whole.metrics_history}
    hist = res.metrics_history
    pairs = [(m["step"], m["loss"], want[m["step"]]) for m in hist]
    rel = max(abs(x - w) / abs(w) for _, x, w in pairs)
    free, total = torch.cuda.mem_get_info()
    print(f"runtime (d): ElasticSpmdTrainer at world 1, flagship widths "
          f"bf16/fp32: the rank killed {t_kill - t0:.1f} s into the fit, "
          f"after checkpoint {ELASTIC_KILL_AT}; failures "
          f"{res.config['failures']}, final world "
          f"{res.config['final_world']}, generations "
          f"{res.config['generations']}; reform {reform_s} s (the "
          f"train.gang.reform event), kill to the fit's end "
          f"{t_end - t_kill:.1f} s; resumed steps "
          f"{[(s, round(x, 7), round(w, 7)) for s, x, w in pairs]}, max "
          f"relative difference from the uninterrupted fit {rel:.3g} (bit "
          f"for bit {all(x == w for _, x, w in pairs)}); card memory free "
          f"after {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"[{gpu_line}]", flush=True)
    check(res.config["failures"] == 1 and res.config["final_world"] == 1
          and res.config["generations"] == 1,
          f"runtime (d): the gang did not reform once at full size: "
          f"{res.config}")
    first = hist[0]["step"] if hist else None
    check(first is not None and first - 1 >= ELASTIC_KILL_AT
          and (first - 1) % ELASTIC_EVERY == 0
          and [m["step"] for m in hist] == list(range(first,
                                                      ELASTIC_STEPS + 1)),
          f"runtime (d): resumed steps {[m['step'] for m in hist]}")
    check(rel <= RUNTIME_RTOL, "runtime (d): a resumed step's loss "
          "differs from the uninterrupted fit's")
    # (e) of phase 19: RAY_TPU_ELASTIC_TRACE, the rank's enter line for
    # each generation
    with open(f"{trace}.r0") as f:
        lines = f.read().splitlines()
    enters = [ln.split(" ", 2)[1:] for ln in lines if " enter " in ln]
    print(f"runtime (d): RAY_TPU_ELASTIC_TRACE {len(lines)} lines in "
          f"{os.path.basename(trace)}.r0, enter lines {enters}", flush=True)
    check([g for g, _ in enters] == ["g0", "g1"]
          and all(m.startswith("enter world=1 pid=") for _, m in enters),
          f"runtime (d): the elastic trace's enter lines {enters}")


def phase_runtime(torch, gpu_line, train_stats):
    """14. runtime: the port's runtime on the card, (a)-(d) (see the
    module docstring). Returns the rank actor's K1/K2a/K2b launches and
    its median step in ms."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    release(torch)
    free, total = torch.cuda.mem_get_info()
    print(f"runtime: card memory free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB before the phase (the driver's caches "
          f"emptied)", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    handle = rt.init()
    try:
        probe = runtime_resources(torch, rt)
        runtime_device_objects(torch, rt, probe)
        launches, rank_ms = runtime_trainer(torch, rt, root, gpu_line,
                                            train_stats)
        runtime_elastic(torch, rt, handle, root, gpu_line)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_no_workers("runtime")
    release(torch)
    return launches, rank_ms


# the serve-deploy phase: the serve phase's model and engine behind the
# serve control plane and the HTTP proxy, one replica holding the card
SERVE_DEPLOY_APP = "serve-deploy"
SERVE_DEPLOY_BURSTS = 3   # measured bursts, after one warm-up burst
SERVE_DEPLOY_ENGINE = dict(kv_page_size=16, max_slots=8, max_seq_len=2048,
                           prefill_buckets=SERVE_BUCKETS,
                           max_prefill_batch=4)
SERVE_DEPLOY_PARITY_ENGINE = dict(kv_page_size=16, max_slots=4,
                                  max_seq_len=2048,
                                  prefill_buckets=(32, 64, 128, 256, 512))
SERVE_DEPLOY_TIMEOUT_S = 600      # a client's wait for one reply
SERVE_DEPLOY_LONE = 5             # lone streamed requests after (b)


def serve_deploy_model():
    """(a)'s model factory, run in the replica: the serve phase's model
    (Llama-3-8B widths, 32 layers, bf16, random weights from seed 0)."""
    import torch
    from ray_tpu_torch.models import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    return Llama(cfg, device="cuda", seed=0), None


def serve_deploy_parity_model():
    """(c)'s model factory, run in the replica: the parity phase's model
    (4 fp32 layers of Llama-3-8B widths, seed 1) with TF32 off in the
    replica's process."""
    import torch
    from ray_tpu_torch.models import Llama, LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    return Llama(cfg, device="cuda", seed=1), None


def serve_deploy_server_cls():
    """The phase's deployment class: OpenAIServer with methods that read,
    in the replica's own process, its card, its engine's device and the
    K1/K3 launch counters. Defined in a function so that the runtime
    pickles it by value into the replica."""
    from ray_tpu_torch.serve.llm.openai_api import OpenAIServer

    class CountingOpenAIServer(OpenAIServer):
        def __init__(self, *args, **kwargs):
            t0 = time.time()
            super().__init__(*args, **kwargs)
            self.init_span = (t0, time.time())

        def where(self, _body=None):
            """The replica's card, engine device, pid, its process's
            start and its __init__'s span (epoch seconds)."""
            import psutil
            from ray_tpu_torch import get_gpu_ids
            return {"gpu_ids": get_gpu_ids(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self.engine.device), "pid": os.getpid(),
                    "started": psutil.Process().create_time(),
                    "init_span": self.init_span}

        def launches(self, body=None):
            """The K1/K3 counts and the decode-graph replays, with the
            engine's "decode_graphs"; with {"zero": True} set to 0
            after."""
            from ray_tpu_torch.models.decode_graph import DecodeGraphs
            from ray_tpu_torch.ops.kernels import flash_attention as fa
            from ray_tpu_torch.ops.kernels import paged_attention as pa
            out = {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
                   "paged_decode (K3)": pa.paged_decode_attention.launches,
                   "decode graph replays": DecodeGraphs.replay.launches,
                   "decode graphs":
                       self.engine.get_stats()["decode_graphs"]}
            if body and body.get("zero"):
                fa.flash_attention_fwd.launches = 0
                pa.paged_decode_attention.launches = 0
                DecodeGraphs.replay.launches = 0
            return out

        def clear_samples(self, _body=None):
            self.engine._timings.clear()
            self.engine._tpot_samples.clear()
            return True

    return CountingOpenAIServer


def http_completion(port, body):
    """One request to /v1/completions: (token ids, completion_tokens,
    seconds to the first SSE chunk or to the whole unary reply). Without
    a tokenizer the server's text is the token ids, space-separated.
    Fails on any status but 200, an error object, or an SSE stream that
    does not end in [DONE]."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=SERVE_DEPLOY_TIMEOUT_S) as r:
        check(r.status == 200, f"HTTP {r.status}")
        if not body.get("stream"):
            out = json.loads(r.read())
            t = time.time() - t0
            check("error" not in out, f"error reply {out}")
            return ([int(x) for x in out["choices"][0]["text"].split()],
                    out["usage"]["completion_tokens"], t)
        check("text/event-stream" in r.headers.get("Content-Type", ""),
              f"stream content type {r.headers.get('Content-Type')}")
        first, events = None, []
        for line in r:
            if line.startswith(b"data: "):
                if first is None:
                    first = time.time() - t0
                events.append(line[len(b"data: "):].strip().decode())
    check(events and events[-1] == "[DONE]", f"SSE ended with {events[-1:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    check(all("error" not in c for c in chunks), f"SSE error {chunks}")
    text = "".join(c["choices"][0]["text"] for c in chunks)
    ids = [int(x) for x in text.split()]
    return ids, len(ids), first


def http_burst(port, bodies):
    """Every body at once over HTTP, one thread each; fails if any
    request fails or does not finish. Returns (results in order, wall
    seconds)."""
    results = [None] * len(bodies)
    errors = []

    def run(i):
        try:
            results[i] = http_completion(port, bodies[i])
        except Exception as e:  # noqa: BLE001  reported below, then fails
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_DEPLOY_TIMEOUT_S)
    wall = time.time() - t0
    check(not errors, f"requests failed: {errors}")
    check(all(not t.is_alive() for t in threads), "requests did not finish")
    return results, wall


def wait_http_200(port, body, timeout_s):
    """Post `body` until a reply is 200; the seconds it took."""
    import http.client
    t0 = time.time()
    while True:
        try:
            http_completion(port, body)
            return time.time() - t0
        except (OSError, RuntimeError, http.client.HTTPException):
            check(time.time() - t0 < timeout_s,
                  f"no 200 reply within {timeout_s} s")
            time.sleep(0.2)


def worker_pids():
    """Pids of this process's runtime workers that are not zombies."""
    import psutil
    out = []
    for p in psutil.Process().children(recursive=True):
        try:
            if (p.status() != psutil.STATUS_ZOMBIE
                    and "core.worker" in " ".join(p.cmdline())):
                out.append(p.pid)
        except psutil.NoSuchProcess:
            pass
    return out


def wait_no_workers(label, timeout_s=30.0):
    deadline = time.time() + timeout_s
    left = worker_pids()
    while left and time.time() < deadline:
        time.sleep(0.2)
        left = worker_pids()
    check(not left, f"{label}: worker processes left after shutdown: {left}")


def serve_deploy_bursts(handle, port, vocab, gpu_line, serve_stats):
    """(b): the serve phase's 8 prompts over HTTP, one warm-up burst and
    SERVE_DEPLOY_BURSTS measured ones; the replica's K1/K3 counters are
    zeroed just before the measured bursts and read just after."""
    import numpy as np
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, n).tolist() for n in SERVE_PLENS]
    bodies = [{"prompt": p, "max_tokens": SERVE_NEW, "temperature": 0.0}
              for p in prompts]
    bodies[2].update(temperature=0.8, top_p=0.9)
    bodies[5]["stream"] = True
    http_burst(port, bodies)                              # warm-up
    handle.launches.remote({"zero": True}).result(timeout_s=60)
    rows = []
    for b in range(SERVE_DEPLOY_BURSTS):
        handle.clear_samples.remote().result(timeout_s=60)
        results, wall = http_burst(port, bodies)
        for i, (ids, n, _t) in enumerate(results):
            check(n == SERVE_NEW and len(ids) == SERVE_NEW,
                  f"serve-deploy (b): request {i} returned {n} tokens "
                  f"({len(ids)} ids), want {SERVE_NEW}")
            check(all(0 <= t < vocab for t in ids),
                  f"serve-deploy (b): request {i} has out-of-vocab tokens")
        st = handle.stats.remote().result(timeout_s=60)
        unary = [t for (_i, _n, t), bd in zip(results, bodies)
                 if not bd.get("stream")]
        row = {"sse_first_ms": 1e3 * results[5][2],
               "unary_p50_ms": 1e3 * statistics.median(unary),
               "decode_tok_s": (len(bodies) * (SERVE_NEW - 1)) / wall,
               "engine_ttft_p50_ms":
                   st["ttft_breakdown_p50_ms"]["total_ms"],
               "engine_tpot_p50_ms": st.get("tpot_p50_ms"),
               "wall_s": wall}
        rows.append(row)
        print(f"serve-deploy (b): burst {b + 1}: " + json.dumps(
            {k: round(v, 3) for k, v in row.items()}), flush=True)
    launches = handle.launches.remote().result(timeout_s=60)
    st = handle.stats.remote().result(timeout_s=60)
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f"serve-deploy (b): medians over {SERVE_DEPLOY_BURSTS} bursts of "
          f"8 requests x {SERVE_NEW} tokens over HTTP (prompts "
          f"{SERVE_PLENS}, one at temperature 0.8 / top_p 0.9, one "
          f"streamed as SSE): client time to the first SSE chunk "
          f"{med['sse_first_ms']:.1f} ms, client p50 time to the whole "
          f"unary reply {med['unary_p50_ms']:.1f} ms, decode tokens/s "
          f"{med['decode_tok_s']:.1f}, the replica engine's TTFT p50 "
          f"{med['engine_ttft_p50_ms']} ms and TPOT p50 "
          f"{med['engine_tpot_p50_ms']} ms, wall {med['wall_s']:.3f} s; "
          f"the in-process serve phase (one burst, logprobs off; here the "
          f"build_openai_deployment's logprobs=True): engine TTFT p50 "
          f"{serve_stats['ttft_p50_ms']} ms, TPOT p50 "
          f"{serve_stats['tpot_p50_ms']} ms, decode tokens/s "
          f"{serve_stats['decode_tok_s']:.1f}; replica launches "
          f"{json.dumps(launches)} [{gpu_line}]", flush=True)
    note_graphs("serve-deploy (b)", launches.pop("decode graphs"),
                launches["decode graph replays"])
    check(launches["flash_fwd (K1)"] > 0 and launches["paged_decode (K3)"] > 0,
          f"serve-deploy (b): the replica's kernels did not run: {launches}")
    free_slots = st["free_slots"] == SERVE_DEPLOY_ENGINE["max_slots"]
    check(st["active"] == 0 and st["waiting"] == 0 and free_slots
          and st["kv_pages"]["in_use"] == 0,
          f"serve-deploy (b): engine slots not free after the bursts: {st}")
    lone = []
    for _ in range(SERVE_DEPLOY_LONE):
        handle.clear_samples.remote().result(timeout_s=60)
        _ids, _n, first = http_completion(port, {
            "prompt": prompts[0], "max_tokens": 4, "temperature": 0.0,
            "stream": True})
        eng = handle.stats.remote().result(timeout_s=60)
        lone.append((1e3 * first,
                     eng["ttft_breakdown_p50_ms"]["total_ms"]))
    print(f"serve-deploy (b): {SERVE_DEPLOY_LONE} lone streamed requests "
          f"({SERVE_PLENS[0]}-token prompt): median client time to the "
          f"first SSE chunk {statistics.median(c for c, _ in lone):.1f} ms, "
          f"the engine's TTFT {statistics.median(e for _, e in lone):.1f} "
          f"ms, the HTTP path's overhead (client minus engine, median) "
          f"{statistics.median(c - e for c, e in lone):.1f} ms [{gpu_line}]",
          flush=True)
    return launches


def serve_deploy_recovery(handle, port, chaos, gpu_line):
    """(d): kill (a)'s replica; poll with requests until one is 200; the
    replacement holds GPU 0 and the old worker process is gone."""
    import psutil
    old = handle.where.remote().result(timeout_s=60)
    t0 = time.time()
    chaos.kill_replica(SERVE_DEPLOY_APP, "OpenAIServer")
    recover_s = wait_http_200(port, {"prompt": [1, 2, 3], "max_tokens": 2,
                                     "temperature": 0.0}, 300)
    new = handle.where.remote().result(timeout_s=60)
    deadline = time.time() + 30
    while psutil.pid_exists(old["pid"]) and time.time() < deadline:
        try:
            if psutil.Process(old["pid"]).status() == psutil.STATUS_ZOMBIE:
                break
        except psutil.NoSuchProcess:
            break
        time.sleep(0.2)
    gone = old["pid"] not in worker_pids()
    init0, init1 = new["init_span"]
    print(f"serve-deploy (d): replica killed (pid {old['pid']}); kill to the "
          f"first 200 reply {recover_s:.2f} s; the replacement's process "
          f"started at +{new['started'] - t0:.2f} s, its __init__ ran from "
          f"+{init0 - t0:.2f} s for {init1 - init0:.2f} s; the replacement: "
          f"pid "
          f"{new['pid']}, get_gpu_ids {new['gpu_ids']}, CUDA_VISIBLE_DEVICES "
          f"{new['visible']!r}, engine on {new['device']}; the old worker "
          f"gone {gone} [{gpu_line}]", flush=True)
    check(new["pid"] != old["pid"] and new["gpu_ids"] == [0]
          and new["visible"] == "0" and new["device"].startswith("cuda"),
          f"serve-deploy (d): the replacement {new}")
    check(gone, f"serve-deploy (d): the killed worker {old['pid']} remains")


def serve_deploy_parity(serve, build, cls, port, parity):
    """(c): the parity phase's model in a replica (fp32, TF32 off there),
    greedy over HTTP, unary and SSE, against plain_greedy's tokens from
    the parity phase (the einsum path, no kernel)."""
    prompts, want = parity
    handle = serve.run(build(serve_deploy_parity_model,
                             engine_config=dict(SERVE_DEPLOY_PARITY_ENGINE),
                             server_cls=cls),
                       name=SERVE_DEPLOY_APP + "-parity",
                       wait_for_ready_timeout_s=600)
    wait_http_200(port, {"prompt": [1, 2, 3], "max_tokens": 1,
                         "temperature": 0.0}, 120)
    handle.launches.remote({"zero": True}).result(timeout_s=60)
    got = {}
    for mode in ("unary", "sse"):
        bodies = [{"prompt": p, "max_tokens": PARITY_NEW,
                   "temperature": 0.0, "stream": mode == "sse"}
                  for p in prompts]
        results, _ = http_burst(port, bodies)
        got[mode] = [ids for ids, _n, _t in results]
    launches = handle.launches.remote().result(timeout_s=60)
    note_graphs("serve-deploy (c)", launches.pop("decode graphs"),
                launches["decode graph replays"])
    for mode, toks in got.items():
        for i, (g, w) in enumerate(zip(toks, want)):
            if g != w:
                print(f"serve-deploy (c): {mode} request {i} served {g} "
                      f"plain {w}", flush=True)
    print(f"serve-deploy (c): fp32 deployment (4 layers of Llama-3-8B "
          f"widths, TF32 off in the replica), {len(prompts)} greedy prompts "
          f"{[len(p) for p in prompts]} over HTTP, unary equal to the plain "
          f"loop {got['unary'] == want}, SSE equal {got['sse'] == want}; "
          f"replica launches {json.dumps(launches)}", flush=True)
    check(got["unary"] == want and got["sse"] == want,
          "serve-deploy (c): served greedy tokens differ from the plain "
          "full-recompute loop")
    check(launches["flash_fwd (K1)"] > 0 and launches["paged_decode (K3)"] > 0,
          f"serve-deploy (c): the replica's kernels did not run: {launches}")
    return launches


def phase_serve_deploy(torch, gpu_line, serve_stats, parity):
    """15. serve-deploy: (a) build_openai_deployment of the serve phase's
    model and engine, one replica with the default GPU reservation, and
    the HTTP proxy; (b) bursts over HTTP; (d) the replica killed and
    replaced; (c) the fp32 deployment against the plain loop; (e)
    shutdown frees the card. Returns the replica's K1/K3 launches of (b)
    and (c)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.serve import chaos
    from ray_tpu_torch.serve.http_proxy import start_proxy
    from ray_tpu_torch.serve.llm.openai_api import build_openai_deployment

    t_phase = time.time()
    release(torch)
    free0, total = torch.cuda.mem_get_info()
    print(f"serve-deploy: card memory free {free0 / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB before the phase", flush=True)
    cls = serve_deploy_server_cls()
    launches = {}
    rt.init()
    try:
        t0 = time.time()
        handle = serve.run(
            build_openai_deployment(serve_deploy_model,
                                    engine_config=dict(SERVE_DEPLOY_ENGINE),
                                    server_cls=cls),
            name=SERVE_DEPLOY_APP, wait_for_ready_timeout_s=600)
        ready_s = time.time() - t0
        _proxy, port = start_proxy(port=0)
        where = handle.where.remote().result(timeout_s=60)
        first_s = wait_http_200(port, {"prompt": [1, 2, 3], "max_tokens": 2,
                                       "temperature": 0.0}, 120)
        init0, init1 = where["init_span"]
        print(f"serve-deploy (a): serve.run to a healthy app {ready_s:.2f} s: "
              f"the replica's process started at +{where['started'] - t0:.2f}"
              f" s, its __init__ (imports, CUDA, the 8B model built from "
              f"seed 0, the engine) ran from +{init0 - t0:.2f} s for "
              f"{init1 - init0:.2f} s; the proxy's first 200 reply "
              f"{first_s:.2f} s after; the replica: get_gpu_ids "
              f"{where['gpu_ids']}, CUDA_VISIBLE_DEVICES "
              f"{where['visible']!r}, engine on {where['device']} "
              f"[{gpu_line}]", flush=True)
        check(where["gpu_ids"] == [0] and where["visible"] == "0"
              and where["device"].startswith("cuda"),
              f"serve-deploy (a): the replica {where}")
        launches["serve-deploy"] = serve_deploy_bursts(
            handle, port, LlamaConfig.llama3_8b().vocab_size, gpu_line,
            serve_stats)
        serve_deploy_recovery(handle, port, chaos, gpu_line)
        serve.delete(SERVE_DEPLOY_APP)
        launches["serve-deploy-parity"] = serve_deploy_parity(
            serve, build_openai_deployment, cls, port, parity)
    finally:
        serve.shutdown()
        rt.shutdown()
    wait_no_workers("serve-deploy (e)")
    release(torch)
    free1, _ = torch.cuda.mem_get_info()
    print(f"serve-deploy (e): after serve.shutdown() and shutdown() no "
          f"worker process is left; card memory free {free1 / 2**30:.2f} GiB "
          f"(before the phase {free0 / 2**30:.2f}); phase wall "
          f"{time.time() - t_phase:.1f} s [{gpu_line}]", flush=True)
    check(free1 >= free0 - 2**30,
          f"serve-deploy (e): card memory not freed: {free1 / 2**30:.2f} GiB "
          f"free, {free0 / 2**30:.2f} before")
    return launches


# the data phase: (a) text to the train cell's step in a rank actor
# through the runtime, (b) the loader alone, (c) the data service
DATA_ROWS = 256            # (a): text rows of TRAIN_SEQ + 1 token ids,
DATA_BLOCK_ROWS = 32       # ... read 32 rows a block (8 blocks)
DATA_STEPS = 8             # ... train steps of TRAIN_BATCH rows each
DATA_LR = 1e-5             # ... adamw's constant lr
DATA_JOB = "chip-smoke-data"
LOADER_BATCHES = 32        # (b): batches of ViT-base's input,
LOADER_SHAPE = (64, 224, 224, 3)   # ... uint8 images from seed 1
LOADER_COPIES = 20         # ... bare pinned copies of one batch timed
# the tune phase: trials of TUNE_LAYERS layers at the 8B widths, each
# holding the card, one at a time
TUNE_LAYERS = 2
TUNE_STEPS = 8
TUNE_LRS = (1e-5, 3e-5, 1e-4, 3e-4)
TUNE_GRACE, TUNE_RF = 2, 2  # ASHA's grace period and reduction factor


def data_text_file(root, vocab):
    """DATA_ROWS lines of TRAIN_SEQ + 1 space-separated token ids, Zipf
    over the whole vocabulary (trainer_batches, seed 0)."""
    rows = next(trainer_batches(DATA_ROWS, TRAIN_SEQ, 0, vocab))["tokens"]
    path = os.path.join(root, "tokens.txt")
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(map(str, r.tolist())) + "\n")
    return path


def data_pipeline(rd, adapters, path):
    """read_text -> tokenize_dataset with a plain callable (the ids as
    written), TRAIN_SEQ + 1 ids a row: input_ids int32, attention_mask
    int8."""
    return adapters.tokenize_dataset(
        rd.read_text(path, block_rows=DATA_BLOCK_ROWS),
        lambda s: [int(t) for t in s.split()], max_length=TRAIN_SEQ + 1)


def data_train_loop(config):
    """TorchTrainer's loop for data (a), in its rank actor: the rank's
    shard through prepare_loader onto the card (the first batch timed
    from the driver's fit), then the train cell's model (seed 0, built
    while the loader prefetches) and DATA_STEPS steps, each step and each
    wait in the loader's next() timed; K1/K2a/K2b zeroed just before the
    steps and read just after."""
    import inspect

    import torch
    from ray_tpu_torch import get_gpu_ids
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step, report
    from ray_tpu_torch.train.utils import prepare_loader

    t_loop = time.time()
    shard = config["datasets"]["train"]
    it = prepare_loader(shard, rank=0, world_size=1, batch_size=TRAIN_BATCH)
    b = next(it)
    torch.cuda.current_stream().synchronize()
    t_first = time.time()
    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    model = Llama(cfg, device="cuda", seed=0)
    tx = make_optimizer("adamw", learning_rate=DATA_LR)
    state, step = make_train_step(model, tx)({"tokens": b["input_ids"]})
    torch.cuda.synchronize()
    rows, waits, times, losses = [], [], [], []
    zero_counters(fa)
    for i in range(DATA_STEPS):
        if i:
            t0 = time.perf_counter()
            b = next(it)
            waits.append(time.perf_counter() - t0)
        rows.append(b["input_ids"])
        t1 = time.time()
        state, m = step(state, {"tokens": b["input_ids"]})
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(m["loss"]))
    launches = read_counters(fa)
    it.close()
    # the shard re-streams the rank's copy of the dataset: its stats
    # hold the plan's backpressure and the exchange, which records its
    # own once the loader's thread has closed the stream
    parent = inspect.getclosurevars(shard._source.make_blocks).nonlocals[
        "parent"]
    st = parent.stats_object()
    deadline = time.time() + 30
    while "random_shuffle" not in st.exchange and time.time() < deadline:
        time.sleep(0.05)
    report({"t_loop": t_loop, "t_first": t_first, "losses": losses,
            "times": times,
            "waits": waits, "launches": launches, "layers": cfg.n_layers,
            "rows": torch.cat(rows).cpu().numpy(),
            "dtypes": [str(b["input_ids"].dtype),
                       str(b["attention_mask"].dtype)],
            "backpressure": st.backpressure, "exchange": st.exchange,
            "gpu_ids": get_gpu_ids(), "pid": os.getpid()})


def data_trainer(torch, rd, adapters, path, root, gpu_line, rank_ms):
    """(a): TorchTrainer with datasets={"train": ds}, ds the pipeline
    shuffled (seed 0) by the exchange; the rank's rows against the same
    pipeline's on the driver, its losses against the in-process step's
    on those batches. Returns (the rank's K1/K2a/K2b launches, every row
    of the dataset on the driver)."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer,
                                     make_optimizer, make_train_step)
    from ray_tpu_torch.train.multihost import _wait_exited

    ds = data_pipeline(rd, adapters, path).random_shuffle(seed=0)
    t0 = time.time()
    res = TorchTrainer(data_train_loop, datasets={"train": ds},
                       scaling_config=ScalingConfig(num_workers=1,
                                                    use_gpu=True),
                       run_config=RunConfig(name="data_trainer",
                                            storage_path=root)).fit()
    t_fit = time.time() - t0
    check(res.error is None, f"data (a): the fit failed: {res.error!r}")
    out = res.metrics_history[-1]
    # the rank's card memory is free once its process has exited
    _wait_exited([out["pid"]], time.monotonic() + 60)
    # the same pipeline on the driver: every row, in the rank's order
    everything = np.concatenate([b["input_ids"] for b in ds.split_for_worker(
        0, 1).iter_batches(batch_size=64)])
    host = everything[:DATA_STEPS * TRAIN_BATCH]
    same_rows = (out["rows"].dtype == host.dtype == np.int32
                 and np.array_equal(out["rows"], host))
    release(torch)
    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    model = Llama(cfg, device="cuda", seed=0)
    batches = [{"tokens": torch.from_numpy(
        host[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).cuda()}
        for i in range(DATA_STEPS)]
    state, step = make_train_step(
        model, make_optimizer("adamw", learning_rate=DATA_LR))(batches[0])
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))
    del state, step, model, batches
    release(torch)
    losses = out["losses"]
    rel = max(abs(x - w) / abs(w) for x, w in zip(losses, want))
    med = statistics.median(out["times"][1:]) * 1e3
    wait = statistics.median(out["waits"]) * 1e3
    bp = {k: v["peak_inflight_bytes"] for k, v in out["backpressure"].items()}
    budget = {v["budget_bytes"] for v in out["backpressure"].values()}
    n = out["layers"] * DATA_STEPS
    print(f"data (a): read_text ({DATA_ROWS} rows of {TRAIN_SEQ + 1} Zipf "
          f"ids, {DATA_BLOCK_ROWS} a block) -> tokenize_dataset -> "
          f"random_shuffle(seed=0) -> TorchTrainer, one rank actor "
          f"(get_gpu_ids {out['gpu_ids']}) reading its shard through "
          f"prepare_loader (batch {TRAIN_BATCH}; {out['dtypes']} on the "
          f"card): fit() to the first batch on the card "
          f"{out['t_first'] - t0:.2f} s (to the loop's start "
          f"{out['t_loop'] - t0:.2f} s: the rank's process, imports and "
          f"arguments; the pipeline in the rank the rest), fit "
          f"{t_fit:.1f} s; median step "
          f"{med:.1f} ms (steps 2-{DATA_STEPS}; each "
          f"{[round(x * 1e3, 1) for x in out['times']]}) beside the "
          f"runtime phase's rank-actor step {rank_ms:.1f} ms; median wait "
          f"in the loader's next() {wait:.3f} ms (each "
          f"{[round(x * 1e3, 3) for x in out['waits']]}); the executor's "
          f"in-flight peak {bp} B of a {sorted(budget)} B budget; the "
          f"exchange in the rank {json.dumps(out['exchange'])}; launches "
          f"{json.dumps(out['launches'])} [{gpu_line}]", flush=True)
    print(f"data (a): the rank's {len(out['rows'])} rows on the card equal "
          f"the driver's rows of the same pipeline bit for bit: "
          f"{same_rows}; losses {[round(x, 6) for x in losses]} against the "
          f"in-process step's on those batches "
          f"{[round(x, 6) for x in want]}, max relative difference "
          f"{rel:.3g} (bit for bit {losses == want})", flush=True)
    check(same_rows, "data (a): the rank's rows differ from the driver's")
    check(out["dtypes"] == ["torch.int32", "torch.int8"],
          f"data (a): dtypes on the card {out['dtypes']}")
    check(len(losses) == DATA_STEPS and rel <= RUNTIME_RTOL,
          "data (a): the rank's losses differ from the in-process step's")
    check(all(map(math.isfinite, losses)), "data (a): a non-finite loss")
    check(out["exchange"].get("random_shuffle", {}).get("map_tasks")
          == DATA_ROWS // DATA_BLOCK_ROWS,
          f"data (a): the exchange did not run in the rank: "
          f"{out['exchange']}")
    check(out["launches"] == {"flash_fwd (K1)": 2 * n,
                              "flash_bwd_dq (K2a)": n,
                              "flash_bwd_dkv (K2b)": n},
          f"data (a): unexpected launch counts {out['launches']}")
    return out["launches"], everything


def data_loader_alone(torch, rd, gpu_line):
    """(b): LOADER_BATCHES batches of ViT-base's uint8 input through
    from_numpy(...).iter_device_batches(prefetch=2), timed to the last
    batch on the card, against a bare pinned host-to-card copy_ of one
    batch; every batch on the card equal to its host rows."""
    import numpy as np
    rng = np.random.RandomState(1)
    per = LOADER_SHAPE[0]
    images = rng.randint(0, 256, (LOADER_BATCHES * per,) + LOADER_SHAPE[1:],
                         dtype=np.uint8)
    ds = rd.from_numpy({"image": images}, block_rows=per)
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in ds.iter_device_batches(batch_size=per, prefetch=2):
        got.append(b["image"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pinned = torch.from_numpy(images[:per]).pin_memory()
    dst = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
    for _ in range(3):
        dst.copy_(pinned, non_blocking=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(LOADER_COPIES):
        dst.copy_(pinned, non_blocking=True)
    e1.record()
    torch.cuda.synchronize()
    bare = LOADER_COPIES * pinned.numel() / (e0.elapsed_time(e1) / 1e3)
    ok = len(got) == LOADER_BATCHES and all(
        g.is_cuda and g.dtype == torch.uint8
        and np.array_equal(g.cpu().numpy(), images[i * per:(i + 1) * per])
        for i, g in enumerate(got))
    print(f"data (b): {LOADER_BATCHES} batches of {LOADER_SHAPE} uint8 "
          f"({images.nbytes / 2**20:.0f} MiB) through "
          f"from_numpy().iter_device_batches(prefetch=2): {dt:.3f} s, "
          f"{images.nbytes / dt / 1e9:.2f} GB/s, against a bare pinned "
          f"copy_ of one batch {bare / 1e9:.2f} GB/s ({LOADER_COPIES} "
          f"copies, CUDA events); every batch on the card equals its host "
          f"rows: {ok} [{gpu_line}]", flush=True)
    check(ok, "data (b): a batch on the card differs from its host rows")
    del got, dst, pinned, images


def data_service_workers():
    from ray_tpu_torch.util import state as state_api
    rows = state_api.list_actors(filters=[("state", "=", "ALIVE")],
                                 limit=1000)
    return sorted(r["class_name"] for r in rows if r["class_name"] in (
        "_DataWorkerImpl", "DataServiceDispatcher"))


def data_service_phase(torch, rd, adapters, path, everything, gpu_line):
    """(c): (a)'s pipeline up to the shuffle (the service refuses a
    cross-slice exchange) registered with to_service(world_size=1), read
    on the card through the service iterator's iter_device_batches: the
    time to the first batch, the set of rows equal to (a)'s, nothing
    left after shutdown_service."""
    import numpy as np
    from ray_tpu_torch.data import service

    t0 = time.time()
    data_pipeline(rd, adapters, path).to_service(DATA_JOB, world_size=1)
    t_reg = time.time() - t0
    it = service.iterator(DATA_JOB)
    rows, first = [], None
    for b in it.iter_device_batches(prefetch=2):
        if first is None:
            torch.cuda.current_stream().synchronize()
            first = time.time() - t0
        rows.append(b["input_ids"].cpu().numpy())
    t_all = time.time() - t0
    rows = np.concatenate(rows)
    same = (len(rows) == len(everything)
            and {r.tobytes() for r in rows}
            == {r.tobytes() for r in everything}
            and len({r.tobytes() for r in rows}) == len(rows))
    stats = dict(it.stats)
    before = data_service_workers()
    service.shutdown_service()
    deadline = time.time() + 30
    left = data_service_workers()
    while left and time.time() < deadline:
        time.sleep(0.2)
        left = data_service_workers()
    print(f"data (c): to_service(world_size=1) of (a)'s pipeline before its "
          f"shuffle, read through the service iterator's "
          f"iter_device_batches: register to the first batch on the card "
          f"{first:.2f} s (to_service itself {t_reg:.2f} s), all "
          f"{len(rows)} rows {t_all:.2f} s (iterator "
          f"{json.dumps(stats)}); the set of rows equals (a)'s: {same}; "
          f"service actors up {before}, after shutdown_service {left} "
          f"[{gpu_line}]", flush=True)
    check(same, "data (c): the service's rows differ from (a)'s")
    check(stats["relay_bytes"] == 0, f"data (c): relayed bytes {stats}")
    check(not left, f"data (c): service actors left: {left}")


def phase_data(torch, gpu_line, rank_ms):
    """16. data: (b) the loader alone, then in a runtime of its own (a)
    the pipeline from text to the train cell's step in a rank actor and
    (c) the data service. Returns the rank's K1/K2a/K2b launches."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.train import adapters

    t_phase = time.time()
    release(torch)
    data_loader_alone(torch, rd, gpu_line)
    release(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    path = data_text_file(root, LlamaConfig.llama3_8b().vocab_size)
    rt.init()
    try:
        launches, everything = data_trainer(torch, rd, adapters, path, root,
                                            gpu_line, rank_ms)
        data_service_phase(torch, rd, adapters, path, everything, gpu_line)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_no_workers("data")
    release(torch)
    print(f"data: phase wall {time.time() - t_phase:.1f} s", flush=True)
    return launches


def tune_batch(vocab):
    """The tune phase's fixed batch: TRAIN_BATCH x (TRAIN_SEQ + 1) Zipf
    ids (trainer_batches, seed 2)."""
    return next(trainer_batches(TRAIN_BATCH, TRAIN_SEQ, 2, vocab))["tokens"]


def tune_model(torch):
    from ray_tpu_torch.models import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b(n_layers=TUNE_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    return Llama(cfg, device="cuda", seed=0), cfg


def tune_trial(config):
    """One trial, in its actor holding the card: TUNE_LAYERS layers at
    the 8B widths (seed 0, bf16 compute, fp32 master, remat), adamw at
    the trial's lr, up to TUNE_STEPS steps on the fixed batch, each
    reported; the card's free memory at entry, K1/K2a/K2b so far."""
    import torch
    from ray_tpu_torch import get_gpu_ids, tune
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step

    t_enter = time.time()
    free, _ = torch.cuda.mem_get_info()
    model, cfg = tune_model(torch)
    batch = {"tokens": torch.from_numpy(tune_batch(cfg.vocab_size)).cuda()}
    state, step = make_train_step(
        model, make_optimizer("adamw", learning_rate=config["lr"]))(batch)
    torch.cuda.synchronize()
    zero_counters(fa)
    for i in range(TUNE_STEPS):
        state, m = step(state, batch)
        tune.report({"loss": float(m["loss"]), "step": i + 1,
                     "t": time.time(), "t_enter": t_enter,
                     "free_gib": free / 2**30, "gpus": get_gpu_ids(),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "launches": read_counters(fa), "pid": os.getpid()})


def tune_losses(torch, lr):
    """The trial's steps in this process on the card: its losses."""
    from ray_tpu_torch.train import make_optimizer, make_train_step
    model, cfg = tune_model(torch)
    batch = {"tokens": torch.from_numpy(tune_batch(cfg.vocab_size)).cuda()}
    state, step = make_train_step(
        model, make_optimizer("adamw", learning_rate=lr))(batch)
    out = []
    for _ in range(TUNE_STEPS):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    del state, step, model, batch
    release(torch)
    return out


def phase_tune(torch, gpu_line):
    """17. tune: a Tuner over TUNE_LRS, each trial reserving the card
    ({"CPU": 1, "GPU": 1}), ASHA stopping on the loss; the trials one at
    a time on GPU [0], their losses the in-process steps', ASHA's stops
    reproduced on the host, the best result the lowest last loss, no
    trial actor left. Returns the trials' K1/K2a/K2b launches and each
    lr's in-process losses."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.util import state as state_api

    t_phase = time.time()
    release(torch)
    free0, total = torch.cuda.mem_get_info()
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    rt.init()
    try:
        t0 = time.time()
        grid = tune.Tuner(
            tune.with_resources(tune_trial, {"CPU": 1, "GPU": 1}),
            param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.ASHAScheduler(
                    mode="min", max_t=TUNE_STEPS, grace_period=TUNE_GRACE,
                    reduction_factor=TUNE_RF)),
            run_config=RunConfig(name="tune", storage_path=root)).fit()
        t_fit = time.time() - t0
        left = [a for a in state_api.list_actors(
            filters=[("state", "=", "ALIVE")], limit=100)
            if a["class_name"] == "_TrialActor"]
        best = grid.get_best_result()
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_no_workers("tune")
    release(torch)
    free1, _ = torch.cuda.mem_get_info()
    trials = [(t.config["lr"], t.status, t.iteration, t.history)
              for t in grid.trials]
    want = {lr: tune_losses(torch, lr) for lr in TUNE_LRS}
    # ASHA fed the in-process losses in the trials' order (one at a time)
    asha = tune.ASHAScheduler(mode="min", max_t=TUNE_STEPS,
                              grace_period=TUNE_GRACE,
                              reduction_factor=TUNE_RF)
    decided = {}
    for lr in TUNE_LRS:
        for i, loss in enumerate(want[lr], 1):
            if asha.on_result(f"lr={lr}", i, loss) == "STOP":
                break
        decided[lr] = i
    launches = {}
    spans = []
    rel = 0.0
    for lr, status, iters, hist in trials:
        last = hist[-1]
        for k, v in last["launches"].items():
            launches[k] = launches.get(k, 0) + v
        got = [m["loss"] for m in hist]
        rel = max([rel] + [abs(x - w) / abs(w)
                           for x, w in zip(got, want[lr])])
        gaps = [b["t"] - a["t"] for a, b in zip(hist, hist[1:])]
        spans.append((hist[0]["t_enter"], last["t"]))
        print(f"tune: trial lr {lr}: {status} after {iters} steps (ASHA on "
              f"the host: {decided[lr]}); entry to its first report "
              f"{hist[0]['t'] - hist[0]['t_enter']:.2f} s, median step "
              f"{statistics.median(gaps) * 1e3:.1f} ms (report to report, "
              f"steps 2-{iters}); get_gpu_ids {last['gpus']}, "
              f"CUDA_VISIBLE_DEVICES {last['visible']!r}, card free at entry "
              f"{last['free_gib']:.2f} GiB; losses "
              f"{[round(x, 6) for x in got]}", flush=True)
        check(last["gpus"] == [0] and last["visible"] == "0",
              f"tune: trial lr {lr} saw {last['gpus']}")
        check(status == "STOPPED" and iters == decided[lr] == len(hist),
              f"tune: trial lr {lr} stopped at {iters} ({status}), ASHA on "
              f"the host says {decided[lr]}")
        check(last["free_gib"] >= free0 / 2**30 - 2,
              f"tune: trial lr {lr} found the card held: "
              f"{last['free_gib']:.2f} GiB free")
        n = TUNE_LAYERS * iters
        check(last["launches"] == {"flash_fwd (K1)": 2 * n,
                                   "flash_bwd_dq (K2a)": n,
                                   "flash_bwd_dkv (K2b)": n},
              f"tune: trial lr {lr} launches {last['launches']}")
    spans.sort()
    apart = all(a[1] < b[0] for a, b in zip(spans, spans[1:]))
    lowest = min(trials, key=lambda t: t[3][-1]["loss"])[0]
    print(f"tune: Tuner.fit of {len(trials)} trials ({TUNE_LAYERS} layers of "
          f"the 8B widths, bf16/fp32, remat, adamw; ASHA max_t "
          f"{TUNE_STEPS}, grace {TUNE_GRACE}, rf {TUNE_RF}) {t_fit:.1f} s; "
          f"one trial on the card at a time: {apart}; losses against the "
          f"in-process steps' max relative difference {rel:.3g}; best "
          f"result lr {best.config['lr']} (lowest last loss: lr {lowest}); "
          f"trial actors left {len(left)}; card free {free0 / 2**30:.2f} "
          f"GiB before, {free1 / 2**30:.2f} after, of "
          f"{total / 2**30:.2f}; launches {json.dumps(launches)}; phase "
          f"wall {time.time() - t_phase:.1f} s [{gpu_line}]", flush=True)
    check(apart, "tune: two trials held the card at once")
    check(rel <= RUNTIME_RTOL, "tune: a trial's losses differ from the "
                               "in-process steps'")
    check(best.config["lr"] == lowest, f"tune: best result {best.config}")
    check(not left, f"tune: trial actors left: {left}")
    check(free1 >= free0 - 2**30, f"tune: card memory not freed: "
                                  f"{free1 / 2**30:.2f} GiB free")
    return launches, want


# the front-doors phase: the dashboard and the CLI, `serve run`, jobs, the
# thin client, rllib's remote env runners and the local cluster
FRONT_HOLD_ELEMS = 32 * 2**20     # (a): the GPU actor's bf16 tensor, 64 MiB
FRONT_JOB_STEPS = 4               # (c): the job's steps of the tune model,
FRONT_JOB_LR = 1e-5               # ... at the tune phase's lowest lr
FRONT_APP = "frontapp"            # (b): the app module `serve run` imports
FRONT_CLIENT_SEQ = 2048           # (d): the client task's prompt
FRONT_CLIENT_TRIPS = 20           # ... round trips of a small task timed
FRONT_RL_ITERS = 2                # (e): PPO iterations
FRONT_WAIT_S = 600                # a subprocess's longest wait

FRONT_APP_SOURCE = '''"""The app `python -m ray_tpu_torch serve run {app}:app`
serves: the parity phase's fp32 model (4 layers of Llama-3-8B widths,
seed 1, TF32 off in the replica) behind build_openai_deployment, with a
server that answers {{"launches": ...}} bodies with the replica's K1/K3
counts and decode-graph replays."""
import os
import time

from ray_tpu_torch.serve.llm.openai_api import (OpenAIServer,
                                                build_openai_deployment)


def parity_model():
    import torch
    from ray_tpu_torch.models import Llama, LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    return Llama(cfg, device="cuda", seed=1), None


class CountingServer(OpenAIServer):
    def __init__(self, *args, **kwargs):
        t0 = time.time()
        super().__init__(*args, **kwargs)
        self.init_span = (t0, time.time())

    def __call__(self, body):
        if isinstance(body, dict) and "launches" in body:
            import psutil
            from ray_tpu_torch import get_gpu_ids
            from ray_tpu_torch.models.decode_graph import DecodeGraphs
            from ray_tpu_torch.ops.kernels import flash_attention as fa
            from ray_tpu_torch.ops.kernels import paged_attention as pa
            out = {{"flash_fwd (K1)": fa.flash_attention_fwd.launches,
                   "paged_decode (K3)": pa.paged_decode_attention.launches,
                   "decode graph replays": DecodeGraphs.replay.launches,
                   "decode graphs":
                       self.engine.get_stats()["decode_graphs"],
                   "gpu_ids": get_gpu_ids(), "pid": os.getpid(),
                   "started": psutil.Process().create_time(),
                   "init_span": self.init_span}}
            if body["launches"] == "zero":
                fa.flash_attention_fwd.launches = 0
                pa.paged_decode_attention.launches = 0
                DecodeGraphs.replay.launches = 0
            return out
        return super().__call__(body)


app = build_openai_deployment(parity_model, engine_config={engine!r},
                              server_cls=CountingServer)
'''

FRONT_JOB_SOURCE = '''"""The job chip_smoke.py submits: a driver of its own that
trains the tune phase's model in one TorchTrainer rank holding the card."""
import json
import sys
import time

t_start = time.time()
sys.path.insert(0, {here!r})
import chip_smoke  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu_torch.train import ScalingConfig, TorchTrainer  # noqa: E402

rt.init()
t_init = time.time()
res = TorchTrainer(chip_smoke.front_job_loop,
                   scaling_config=ScalingConfig(num_workers=1)).fit()
rt.shutdown()
if res.error is not None:
    raise SystemExit(f"job: TorchTrainer failed: {{res.error!r}}")
steps = [m for m in res.metrics_history if "loss" in m]
final = [m for m in res.metrics_history if "launches" in m][-1]
print("JOB " + json.dumps({{"losses": [m["loss"] for m in steps],
                           "t": [m["t"] for m in steps], "t_start": t_start,
                           "t_init": t_init, **final}}), flush=True)
'''

FRONT_CLIENT_SOURCE = '''"""A thin client of chip_smoke.py's client host: runs the
forward task, times small round trips and reaches a named GPU actor."""
import hashlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, {here!r})
import chip_smoke  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402

t0 = time.time()
import torch  # noqa: E402
out = {{"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "torch_import_s": time.time() - t0}}
rt.init(address=sys.argv[1])
forward = rt.remote(num_gpus=1)(chip_smoke.front_client_forward)
t0 = time.time()
ref = forward.remote()
rt.wait([ref], timeout=600)
t_ready = time.time()
row, checksum, launches, task = rt.get(ref, timeout=600)
out.update(t0=t0, t_ready=t_ready, t_got=time.time(), device=str(row.device),
           dtype=str(row.dtype), shape=list(row.shape),
           sha=hashlib.sha256(row.cpu().numpy().tobytes()).hexdigest(),
           checksum=checksum, launches=launches, task=task)
if row.is_cuda:
    out["client_checksum"] = float(row.double().sum())
noop = rt.remote(chip_smoke.front_noop)
rt.get(noop.remote())
trips = []
for _ in range(chip_smoke.FRONT_CLIENT_TRIPS):
    t1 = time.perf_counter()
    rt.get(noop.remote())
    trips.append((time.perf_counter() - t1) * 1e3)
out["round_trip_ms"] = statistics.median(trips)
probe = rt.remote(num_gpus=1)(chip_smoke.FrontClientProbe)
probe.options(name="front-probe").remote()
handle = rt.get_actor("front-probe")
out["actor"] = rt.get(handle.info.remote(), timeout=300)
rt.kill(handle)
out["cuda_initialized"] = torch.cuda.is_initialized()
rt.shutdown()
print("CLIENT " + json.dumps(out), flush=True)
'''


class FrontDoorProbe:
    """(a)'s GPU actor (made remote with num_gpus=1): holds a bf16
    tensor on its card."""

    def hold(self, n):
        import torch
        from ray_tpu_torch import get_gpu_ids
        self.t = torch.ones(n, device="cuda", dtype=torch.bfloat16)
        return {"gpu_ids": get_gpu_ids(), "pid": os.getpid(),
                "bytes": self.t.numel() * self.t.element_size()}


class FrontClientProbe:
    """(d)'s named actor, created through the client with num_gpus=1."""

    def info(self):
        from ray_tpu_torch import get_gpu_ids
        return {"gpu_ids": get_gpu_ids(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def front_noop():
    return None


def front_client_forward():
    """(d)'s task, on the card it reserved: 2 layers of the 8B widths in
    bf16 (seed 0) forward over a FRONT_CLIENT_SEQ-token prompt (seed 3);
    the last row's logits as an fp32 CUDA tensor, their sum taken on the
    card, K1's launches (zeroed just before) and the task's GPU ids."""
    import psutil
    import torch
    from ray_tpu_torch import get_gpu_ids
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    t_enter = time.time()
    cfg = LlamaConfig.llama3_8b(n_layers=2, dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    model = Llama(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    t_built = time.time()
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, FRONT_CLIENT_SEQ),
                           device="cuda", generator=gen)
    zero_counters(fa)
    with torch.no_grad():
        out = model(tokens)
    logits = out[0] if isinstance(out, tuple) else out
    row = logits[0, -1].float().clone()
    checksum = float(row.double().sum())
    return row, checksum, fa.flash_attention_fwd.launches, {
        "gpu_ids": get_gpu_ids(), "pid": os.getpid(),
        "started": psutil.Process().create_time(), "t_enter": t_enter,
        "t_built": t_built, "t_done": time.time()}


def front_job_loop(config):
    """(c)'s job, in its TorchTrainer rank on the card: the tune phase's
    model and batch, adamw at FRONT_JOB_LR, FRONT_JOB_STEPS steps, each
    reported with its end time; K1/K2a/K2b zeroed just before the steps
    and read just after."""
    import psutil
    import torch
    from ray_tpu_torch import get_gpu_ids
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step, report
    t_loop = time.time()
    model, cfg = tune_model(torch)
    batch = {"tokens": torch.from_numpy(tune_batch(cfg.vocab_size)).cuda()}
    state, step = make_train_step(
        model, make_optimizer("adamw", learning_rate=FRONT_JOB_LR))(batch)
    torch.cuda.synchronize()
    t_built = time.time()
    zero_counters(fa)
    for i in range(FRONT_JOB_STEPS):
        state, m = step(state, batch)
        report({"step": i + 1, "loss": float(m["loss"]), "t": time.time()})
    report({"launches": read_counters(fa), "gpu_ids": get_gpu_ids(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "started": psutil.Process().create_time(), "t_loop": t_loop,
            "t_built": t_built})


def front_env(**extra):
    """The environment of a process this phase starts: the checkout on
    PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def front_cli(*argv, timeout=120):
    """`python -m ray_tpu_torch <argv>`; fails unless it exits 0."""
    res = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv],
                         cwd=HERE, env=front_env(), capture_output=True,
                         text=True, timeout=timeout)
    check(res.returncode == 0,
          f"front doors: `ray_tpu_torch {' '.join(argv)}` exited "
          f"{res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    return res.stdout


def front_descendants(pid):
    import psutil
    try:
        return psutil.Process(pid).children(recursive=True)
    except psutil.NoSuchProcess:
        return []


def front_gone(procs, label, timeout_s=30.0):
    """Fails unless every process of `procs` has exited within
    timeout_s."""
    import psutil
    deadline = time.time() + timeout_s
    while True:
        alive = []
        for p in procs:
            try:
                if p.is_running() and p.status() != psutil.STATUS_ZOMBIE:
                    alive.append(p.pid)
            except psutil.NoSuchProcess:
                pass
        if not alive or time.time() > deadline:
            break
        time.sleep(0.2)
    check(not alive, f"{label}: processes left: {alive}")


def front_memory_back(torch, free0, label, timeout_s=30.0):
    """Fails unless the card's free memory is back within 1 GiB of
    free0 within timeout_s; returns it."""
    deadline = time.time() + timeout_s
    while True:
        free, _ = torch.cuda.mem_get_info()
        if free >= free0 - 2**30 or time.time() > deadline:
            break
        time.sleep(0.5)
    check(free >= free0 - 2**30,
          f"{label}: card memory not freed: {free / 2**30:.2f} GiB free, "
          f"{free0 / 2**30:.2f} before")
    return free


def front_dashboard_cli(torch, rt, gpu_line):
    """(a): a num_gpus=1 actor holding FRONT_HOLD_ELEMS bf16 on its card,
    the dashboard and the CLI's state verbs against it, memory_summary,
    and `lint`. Returns the dashboard's URL and the actor."""
    import tempfile

    from ray_tpu_torch.observability import memory_summary, start_dashboard
    t0 = time.time()
    dash = start_dashboard(port=0)
    holder = rt.remote(num_gpus=1)(FrontDoorProbe).remote()
    held = rt.get(holder.hold.remote(FRONT_HOLD_ELEMS), timeout=300)
    t_actor = time.time() - t0
    url = dash.url
    t1 = time.time()
    status = json.loads(front_cli("--address", url, "status"))
    actors = json.loads(front_cli("--address", url, "list", "actors",
                                  "--json"))
    workers = json.loads(front_cli("--address", url, "list", "workers",
                                   "--json"))
    table = front_cli("--address", url, "list", "workers")
    summary = json.loads(front_cli("--address", url, "summary", "tasks"))
    metrics = front_cli("--address", url, "metrics")
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "timeline.json")
        front_cli("--address", url, "timeline", "-o", path)
        with open(path) as f:
            events = json.load(f)
    t_cli = time.time() - t1
    actor = next(a for a in actors if a["class_name"] == "FrontDoorProbe")
    worker = next(w for w in workers if w["worker_id"] == actor["worker_id"])
    mem = memory_summary()
    rss = {w["worker_id"]: w["rss_bytes"] for w in mem["workers"]}
    t2 = time.time()
    lint = front_cli("lint", timeout=300).strip().splitlines()[-1]
    t_lint = time.time() - t2
    print(f"front doors (a): dashboard {url}; a num_gpus=1 actor holding "
          f"{held['bytes'] / 2**20:.0f} MiB of bf16 on its card (ready "
          f"{t_actor:.2f} s after the dashboard); the CLI's status, list "
          f"actors/workers, summary tasks, metrics and timeline "
          f"({len(events)} events) in {t_cli:.2f} s: cluster resources "
          f"{status['resources_total']}, the actor {actor['state']} on "
          f"worker {worker['worker_id']} with gpu_ids {worker['gpu_ids']} "
          f"(its RSS {rss.get(worker['worker_id'], 0) / 2**20:.0f} MiB in "
          f"memory_summary), {summary['total']} tasks; `lint`: {lint} in "
          f"{t_lint:.2f} s [{gpu_line}]", flush=True)
    check(status["resources_total"].get("GPU") == 1,
          f"front doors (a): /api/cluster resources {status}")
    check(actor["state"] == "ALIVE" and worker["gpu_ids"] == [0]
          and held["gpu_ids"] == [0],
          f"front doors (a): the actor {actor}, its worker {worker}")
    check("gpu_ids" in table.splitlines()[0],
          f"front doors (a): `list workers` header {table.splitlines()[0]}")
    check(rss.get(worker["worker_id"], 0) > 0,
          f"front doors (a): memory_summary has no RSS of the actor's "
          f"worker: {mem['workers']}")
    check(events and "(counter)" in metrics,
          "front doors (a): empty timeline or metrics")
    check(" 0 findings" in lint, f"front doors (a): lint: {lint}")
    return url, holder


def front_jobs(torch, rt, url, job_losses, gpu_line):
    """(c): the job script submitted with `job submit --remote` through
    (a)'s dashboard, followed with `job logs --follow`, then `job status`
    and `job list`; its losses against the same steps in-process, its
    K1/K2a/K2b against the step's. Then `job stop` of a sleeping CPU job.
    Returns the job's launches."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_job_")
    try:
        path = os.path.join(root, "job.py")
        with open(path, "w") as f:
            f.write(FRONT_JOB_SOURCE.format(here=HERE))
        t_submit = time.time()
        sid = front_cli("--address", url, "job", "submit", "--remote",
                        "--no-wait", "--", sys.executable, path).strip()
        logs = front_cli("--address", url, "job", "logs", "--follow", sid,
                         timeout=FRONT_WAIT_S)
        t_end = time.time()
        status = front_cli("--address", url, "job", "status", sid).strip()
        listed = front_cli("--address", url, "job", "list")
        lines = [ln for ln in logs.splitlines() if ln.strip()]
        check(status == "SUCCEEDED" and lines
              and lines[-1].startswith("JOB "),
              f"front doors (c): job {sid} {status}:\n{logs[-3000:]}")
        job = json.loads(lines[-1][len("JOB "):])
        losses, want = job["losses"], job_losses[:FRONT_JOB_STEPS]
        rel = max(abs(x - w) / abs(w) for x, w in zip(losses, want))
        n = TUNE_LAYERS * FRONT_JOB_STEPS
        print(f"front doors (c): job {sid} ({TUNE_LAYERS} layers of the 8B "
              f"widths, {FRONT_JOB_STEPS} steps at lr {FRONT_JOB_LR} in one "
              f"TorchTrainer rank on get_gpu_ids {job['gpu_ids']}, "
              f"CUDA_VISIBLE_DEVICES {job['visible']!r}): {status}; submit "
              f"to the first step's end {job['t'][0] - t_submit:.2f} s (the "
              f"job's script started at +{job['t_start'] - t_submit:.2f} s, "
              f"its init() done at +{job['t_init'] - t_submit:.2f}, the "
              f"rank's process started at +{job['started'] - t_submit:.2f}, "
              f"its loop at +{job['t_loop'] - t_submit:.2f}, the model and "
              f"step built at +{job['t_built'] - t_submit:.2f}), submit to "
              f"`job logs --follow` returning {t_end - t_submit:.2f} s; "
              f"losses "
              f"{[round(x, 6) for x in losses]} against the in-process "
              f"steps' {[round(x, 6) for x in want]}, max relative "
              f"difference {rel:.3g} (bit for bit {losses == want}); "
              f"launches {json.dumps(job['launches'])} [{gpu_line}]",
              flush=True)
        check(sid in listed, f"front doors (c): `job list` lacks {sid}")
        check(job["gpu_ids"] == [0] and job["visible"] == "0",
              f"front doors (c): the job's rank saw {job['gpu_ids']}")
        check(len(losses) == FRONT_JOB_STEPS and rel <= RUNTIME_RTOL,
              "front doors (c): the job's losses differ from the "
              "in-process steps'")
        check(job["launches"] == {"flash_fwd (K1)": 2 * n,
                                  "flash_bwd_dq (K2a)": n,
                                  "flash_bwd_dkv (K2b)": n},
              f"front doors (c): the job's launches {job['launches']}")
        sleeper = front_cli(
            "--address", url, "job", "submit", "--remote", "--no-wait",
            "--", sys.executable, "-c",
            "'import time; time.sleep(600)'").strip()
        deadline = time.time() + 30
        while (front_cli("--address", url, "job", "status",
                         sleeper).strip() != "RUNNING"
               and time.time() < deadline):
            time.sleep(0.2)
        t0 = time.time()
        stopped = front_cli("--address", url, "job", "stop", sleeper).strip()
        after = front_cli("--address", url, "job", "status", sleeper).strip()
        print(f"front doors (c): `job stop` of a sleeping CPU job: "
              f"{stopped!r}, then {after} in {time.time() - t0:.2f} s",
              flush=True)
        check(after == "STOPPED", f"front doors (c): stopped job {after}")
        return job["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def front_rllib(torch, rt, gpu_line):
    """(e): PPO on GridWorld with 2 remote env runners (2 envs x 8 steps
    each) and the learner on the card, FRONT_RL_ITERS iterations; each
    runner's process sees no card, the learner's params stay on it, and
    stop() kills the runners."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.rl_module import tree_leaves
    from ray_tpu_torch.util import state as state_api
    t0 = time.time()
    algo = (rllib.PPOConfig().environment(rllib.GridWorld)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(num_epochs=1, minibatch_size=16).debugging(seed=0)
            .build())
    totals = [algo.train()["timesteps_total"] for _ in range(FRONT_RL_ITERS)]
    t_fit = time.time() - t0
    on_card = all(t.is_cuda for _, t in tree_leaves(algo.params))
    rows = state_api.list_actors(
        filters=[("class_name", "=", "_RemoteRunner"),
                 ("state", "=", "ALIVE")], limit=100)
    pids = {w["worker_id"]: w["pid"]
            for w in state_api.list_workers(limit=1000)}
    visible = []
    for r in rows:
        with open(f"/proc/{pids[r['worker_id']]}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                       if b"=" in kv)
        visible.append(env.get(b"CUDA_VISIBLE_DEVICES", b"unset").decode())
    algo.stop()
    deadline = time.time() + 30
    while time.time() < deadline and state_api.list_actors(
            filters=[("class_name", "=", "_RemoteRunner"),
                     ("state", "=", "ALIVE")], limit=100):
        time.sleep(0.2)
    left = state_api.list_actors(
        filters=[("class_name", "=", "_RemoteRunner"),
                 ("state", "=", "ALIVE")], limit=100)
    print(f"front doors (e): PPO on GridWorld, 2 remote env runners x 2 "
          f"envs x 8 steps, the learner on {algo.device}: timesteps_total "
          f"{totals} in {t_fit:.2f} s (build included); the runners' "
          f"CUDA_VISIBLE_DEVICES {visible}; the learner's params on the "
          f"card {on_card}; runners alive after stop() {len(left)} "
          f"[{gpu_line}]", flush=True)
    check(totals == [32 * (i + 1) for i in range(FRONT_RL_ITERS)],
          f"front doors (e): timesteps_total {totals}")
    check(visible == ["", ""], f"front doors (e): runners saw {visible}")
    check(on_card, "front doors (e): the learner's params left the card")
    check(not left, f"front doors (e): runners left after stop(): {left}")


class FrontServeRun:
    """(b): one `python -m ray_tpu_torch serve run frontapp:app --port 0
    --dashboard-port 0` process, started at construction from `root`
    (the app module's directory, also on its PYTHONPATH)."""

    def __init__(self, root):
        env = front_env()
        env["PYTHONPATH"] = os.pathsep.join([root, env["PYTHONPATH"]])
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "serve", "run",
             f"{FRONT_APP}:app", "--port", "0", "--dashboard-port", "0"],
            cwd=root, env=env, stdout=subprocess.PIPE, text=True)

    @staticmethod
    def write_app(root):
        with open(os.path.join(root, f"{FRONT_APP}.py"), "w") as f:
            f.write(FRONT_APP_SOURCE.format(
                app=FRONT_APP, engine=dict(SERVE_DEPLOY_PARITY_ENGINE)))

    def ready(self):
        """Reads the banner and the dashboard's URL, then polls until a
        reply is 200; the seconds from the process's start to then."""
        banner = self.proc.stdout.readline().strip()
        self.t_banner = time.time()
        self.dash = self.proc.stdout.readline().strip().rsplit(" ", 1)[-1]
        check(banner.startswith(f"serving {FRONT_APP}:app on http://"),
              f"front doors (b): serve run printed {banner!r}")
        self.port = int(banner.rsplit(":", 1)[-1])
        wait_http_200(self.port, {"prompt": [1, 2, 3], "max_tokens": 1,
                                  "temperature": 0.0}, FRONT_WAIT_S)
        self.t_first = time.time() - self.t0
        return self.t_first

    def post(self, body):
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def parity(self, parity, gpu_line):
        """The fp32 app's greedy tokens over HTTP (unary and SSE) against
        the plain loop, K1/K3 counted in the replica (zeroed just before)
        and `serve status` through its dashboard. Returns the replica's
        launches."""
        prompts, want = parity
        self.post({"launches": "zero"})
        got = {}
        for mode in ("unary", "sse"):
            bodies = [{"prompt": p, "max_tokens": PARITY_NEW,
                       "temperature": 0.0, "stream": mode == "sse"}
                      for p in prompts]
            results, _ = http_burst(self.port, bodies)
            got[mode] = [ids for ids, _n, _t in results]
        counts = self.post({"launches": "read"})
        launches = {k: counts[k] for k in ("flash_fwd (K1)",
                                           "paged_decode (K3)")}
        note_graphs("front doors (b)", counts["decode graphs"],
                    counts["decode graph replays"])
        init0, init1 = counts["init_span"]
        status = json.loads(front_cli("--address", self.dash, "serve",
                                      "status"))
        t0 = self.t0
        print(f"front doors (b): `serve run {FRONT_APP}:app` (the parity "
              f"phase's fp32 model, TF32 off in the replica): process start "
              f"to the first 200 reply {self.t_first:.2f} s (its banner at "
              f"+{self.t_banner - t0:.2f} s; the replica's process started "
              f"at +{counts['started'] - t0:.2f} s, its __init__ ran from "
              f"+{init0 - t0:.2f} s for {init1 - init0:.2f} s); "
              f"{len(prompts)} greedy prompts over HTTP, unary equal to "
              f"the plain loop {got['unary'] == want}, SSE equal "
              f"{got['sse'] == want}; the replica on get_gpu_ids "
              f"{counts['gpu_ids']}, launches {json.dumps(launches)}; "
              f"`serve status` through its dashboard: running "
              f"{status.get('running')}, apps "
              f"{sorted(status.get('applications', {}))} [{gpu_line}]",
              flush=True)
        check(got["unary"] == want and got["sse"] == want,
              "front doors (b): served greedy tokens differ from the plain "
              "full-recompute loop")
        check(launches["flash_fwd (K1)"] > 0
              and launches["paged_decode (K3)"] > 0,
              f"front doors (b): the replica's kernels did not run: "
              f"{launches}")
        check(counts["gpu_ids"] == [0],
              f"front doors (b): the replica saw {counts['gpu_ids']}")
        check(status.get("running") is True
              and "default" in status.get("applications", {}),
              f"front doors (b): serve status {status}")
        return launches

    def stop(self, torch, sig, free0, gpu_line):
        """Signal `sig`: the process exits, leaves no process and the
        card's memory comes back."""
        import signal
        name = signal.Signals(sig).name
        kids = front_descendants(self.proc.pid)
        check(any("core.worker" in " ".join(k.cmdline()) for k in kids),
              "front doors (b): serve run has no worker process")
        t1 = time.time()
        self.proc.send_signal(sig)
        rc = self.proc.wait(timeout=60)
        front_gone(kids, f"front doors (b): serve run after {name}")
        free = front_memory_back(torch, free0,
                                 f"front doors (b) after {name}")
        print(f"front doors (b): {name} to serve run: exit code {rc}, its "
              f"{len(kids)} processes gone and the card's memory back "
              f"({free / 2**30:.2f} GiB free, {free0 / 2**30:.2f} before) in "
              f"{time.time() - t1:.2f} s [{gpu_line}]", flush=True)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()


def front_client(torch, gpu_line):
    """(d): a client host with one card, a client that sees the card and
    one that does not (CUDA_VISIBLE_DEVICES=""), each running the forward
    task through init(address="ray://..."); a named GPU actor reached
    through each client; the host outlives its clients and leaves no
    process when terminated (the card's memory is checked after (b)'s
    second run, which overlaps this). Returns the task's K1 launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import LlamaConfig
    vocab = LlamaConfig.llama3_8b().vocab_size
    root = tempfile.mkdtemp(prefix="chip_smoke_client_")
    host = None
    try:
        path = os.path.join(root, "client.py")
        with open(path, "w") as f:
            f.write(FRONT_CLIENT_SOURCE.format(here=HERE))
        t0 = time.time()
        host = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.client.server", "--listen",
             "127.0.0.1:0", "--num-gpus", "1"], cwd=HERE, env=front_env(),
            stdout=subprocess.PIPE, text=True)
        address = host.stdout.readline().strip()
        t_host = time.time() - t0
        check(address.startswith("ray://"),
              f"front doors (d): the host printed {address!r}")
        runs = {}
        for label, extra in (("card", {}),
                             ("cpu", {"CUDA_VISIBLE_DEVICES": ""})):
            t1 = time.time()
            res = subprocess.run([sys.executable, path, address], cwd=HERE,
                                 env=front_env(**extra), capture_output=True,
                                 text=True, timeout=FRONT_WAIT_S)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("CLIENT ")]
            check(res.returncode == 0 and lines,
                  f"front doors (d): the {label} client failed:\n"
                  f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
            runs[label] = json.loads(lines[-1][len("CLIENT "):])
            runs[label]["wall_s"] = time.time() - t1
        card, cpu = runs["card"], runs["cpu"]
        check(host.poll() is None, "front doors (d): the host exited")
        kids = front_descendants(host.pid)
        host.terminate()
        rc = host.wait(timeout=60)
        front_gone(kids, "front doors (d): the client host after SIGTERM")
        for label, r in runs.items():
            task = r["task"]
            print(f"front doors (d): the {label} client "
                  f"(CUDA_VISIBLE_DEVICES {r['visible']!r}): the task "
                  f"(get_gpu_ids {task['gpu_ids']}, worker pid "
                  f"{task['pid']}, K1 {r['launches']}) returned a "
                  f"{r['dtype']} {r['shape']} tensor on {r['device']} "
                  f"{r['t_got'] - r['t0']:.2f} s after its submit: the "
                  f"worker's process started at "
                  f"{task['started'] - r['t0']:+.2f} s, the task entered at "
                  f"+{task['t_enter'] - r['t0']:.2f} s, built the model in "
                  f"{task['t_built'] - task['t_enter']:.2f} s and ran the "
                  f"forward in {task['t_done'] - task['t_built']:.2f} s, "
                  f"the client's wait returned "
                  f"{r['t_ready'] - task['t_done']:.2f} s later and its get "
                  f"{r['t_got'] - r['t_ready']:.2f} s after that (the "
                  f"client imported torch in {r['torch_import_s']:.2f} s "
                  f"before it submitted); CUDA initialised "
                  f"in the client {r['cuda_initialized']}; median round trip "
                  f"of a small task {r['round_trip_ms']:.2f} ms over "
                  f"{FRONT_CLIENT_TRIPS}; the named actor saw "
                  f"{r['actor']}; the client's wall {r['wall_s']:.2f} s "
                  f"[{gpu_line}]", flush=True)
        print(f"front doors (d): host up in {t_host:.2f} s and alive after "
              f"both clients; SIGTERM: exit code {rc}, its {len(kids)} "
              f"processes gone; the card "
              f"client's checksum on its card {card.get('client_checksum')} "
              f"against the task's {card['checksum']}; the two clients' "
              f"bytes equal {card['sha'] == cpu['sha']}", flush=True)
        check(card["device"].startswith("cuda")
              and card.get("client_checksum") == card["checksum"],
              f"front doors (d): the card client got {card}")
        check(cpu["device"] == "cpu" and cpu["cuda_initialized"] is False
              and cpu["sha"] == card["sha"],
              f"front doors (d): the CPU client got {cpu}")
        for r in (card, cpu):
            check(r["task"]["gpu_ids"] == [0] and r["launches"] == 2
                  and r["actor"] == {"gpu_ids": [0], "visible": "0"}
                  and r["shape"] == [vocab],
                  f"front doors (d): {r}")
        return {"flash_fwd (K1)": card["launches"] + cpu["launches"]}
    finally:
        if host is not None and host.poll() is None:
            host.kill()
        shutil.rmtree(root, ignore_errors=True)


def front_cluster(torch, rt, gpu_line):
    """(f): cluster_utils.Cluster with the head (counting the host's
    card) and one agent (num_gpus 0): the cluster's one GPU, a num_gpus=1
    task on the head's node, a CPU task pinned to the agent there, and
    no agent left after shutdown."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    @rt.remote(num_gpus=1)
    def gpu_where():
        from ray_tpu_torch import get_gpu_ids
        return os.environ.get("RAY_TPU_NODE_ID"), get_gpu_ids()

    @rt.remote(num_cpus=1)
    def cpu_where():
        return os.environ.get("RAY_TPU_NODE_ID")

    t0 = time.time()
    cluster = Cluster(head_cpus=4)
    try:
        head = cluster._rt.node_id
        agent = cluster.add_node(num_cpus=2)
        t_up = time.time() - t0
        res = rt.cluster_resources()
        node, ids = rt.get(gpu_where.remote(), timeout=300)
        on_agent = rt.get(cpu_where.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                agent, soft=False)).remote(), timeout=300)
    finally:
        agents = list(cluster._agents)
        cluster.shutdown()
    left = [p.pid for p in agents if p.poll() is None]
    print(f"front doors (f): a head and one agent (--num-gpus 0) up in "
          f"{t_up:.2f} s: cluster resources GPU {res.get('GPU')}, CPU "
          f"{res.get('CPU')}; the num_gpus=1 task on the head "
          f"{node == head} with get_gpu_ids {ids}; the pinned CPU task on "
          f"the agent {on_agent == agent}; agents left after shutdown "
          f"{left} [{gpu_line}]", flush=True)
    check(res.get("GPU") == 1, f"front doors (f): cluster resources {res}")
    check(node == head and ids == [0],
          f"front doors (f): the GPU task ran on {node} with {ids}")
    check(on_agent == agent, f"front doors (f): the pinned task ran on "
                             f"{on_agent}, not the agent {agent}")
    check(not left, f"front doors (f): agents left: {left}")


def phase_front_doors(torch, gpu_line, parity, job_losses):
    """18. front doors: (a) the dashboard and the CLI, (c) a job, (e)
    rllib's remote env runners in one runtime; then (b) `serve run`
    twice (SIGINT; then SIGTERM, the second run coming up while (d)'s
    clients run), (d) the thin client and (f) the local cluster. Returns
    the launches of `serve run`'s replica, the job and the client's
    task."""
    import shutil
    import signal
    import tempfile

    import ray_tpu_torch as rt

    t_phase = time.time()
    release(torch)
    free0, total = torch.cuda.mem_get_info()
    print(f"front doors: card memory free {free0 / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB before the phase", flush=True)
    launches = {}
    rt.init()
    try:
        url, holder = front_dashboard_cli(torch, rt, gpu_line)
        rt.kill(holder)          # the job's own runtime takes the card
        launches["job"] = front_jobs(torch, rt, url, job_losses, gpu_line)
        front_rllib(torch, rt, gpu_line)
    finally:
        from ray_tpu_torch.observability import stop_dashboard
        stop_dashboard()
        rt.shutdown()
    wait_no_workers("front doors (a, c, e)")
    release(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_run_")
    runs = []
    try:
        FrontServeRun.write_app(root)
        runs.append(FrontServeRun(root))
        runs[0].ready()
        launches["cli-serve"] = runs[0].parity(parity, gpu_line)
        runs[0].stop(torch, signal.SIGINT, free0, gpu_line)
        # the second run, ended by SIGTERM, comes up while the clients run
        runs.append(FrontServeRun(root))
        launches["client"] = front_client(torch, gpu_line)
        runs[1].ready()
        runs[1].stop(torch, signal.SIGTERM, free0, gpu_line)
    finally:
        for run in runs:
            run.kill()
        shutil.rmtree(root, ignore_errors=True)
    front_cluster(torch, rt, gpu_line)
    wait_no_workers("front doors (f)")
    release(torch)
    front_memory_back(torch, free0, "front doors")
    print(f"front doors: phase wall {time.time() - t_phase:.1f} s "
          f"[{gpu_line}]", flush=True)
    return launches


# phase 19, pinned routes and the rest: attn_impl and the paged knob at
# the parity phase's shape, the K1 / einsum / SDPA crossover, workflows,
# fractional GPUs (the elastic trace rides the runtime phase's (d))
PINNED_SETTINGS = (        # (label, attn_impl, RAY_TPU_PAGED_ATTN_IMPL)
    ("xla + gather", "xla", "gather"),
    ("pallas + pallas", "pallas", "pallas"),
    ("dpa", "dpa", "auto"),
    ("auto", "auto", "auto"),
)
PINNED_TRAIN_LAYERS = 2
CROSS_SEQS = (128, 512, 2048, 4096)   # (b): forward at each S ...
CROSS_BWD_SEQS = (512, 2048)          # ... and forward plus backward
CROSS_SHAPE = (1, 32, 8, 128)         # B, Hq, Hkv, D (Llama-3-8B), bf16
WF_LAYERS = 2                         # (c), (d): 8B widths, bf16
WF_SEQ = 2048
FRAC_ITERS = 40                       # (d): forwards in each actor's call


def pinned_greedy(torch, model, prompts, paged):
    """PARITY_NEW greedy tokens of each prompt on a fresh paged engine
    (page 16) under RAY_TPU_PAGED_ATTN_IMPL=`paged`, and the K1 and K3
    launches of the run (zeroed just before it)."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
    os.environ["RAY_TPU_PAGED_ATTN_IMPL"] = paged
    try:
        engine = LLMEngine(model, None, LLMEngineConfig(
            max_slots=4, max_seq_len=2048, kv_page_size=16,
            prefill_buckets=(32, 64, 128, 256, 512)), device="cuda")
        zero_counters(fa)
        pa.paged_decode_attention.launches = 0
        replays = graph_replays()
        try:
            rids = [engine.submit(p, max_new_tokens=PARITY_NEW)
                    for p in prompts]
            got = [list(engine.stream(r)) for r in rids]
            state = engine.get_stats()["decode_graphs"]
        finally:
            engine.shutdown()
        note_graphs(f"pinned: {model.cfg.attn_impl}, paged {paged}", state,
                    graph_replays() - replays)
    finally:
        os.environ.pop("RAY_TPU_PAGED_ATTN_IMPL", None)
    return got, {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
                 "paged_decode (K3)": pa.paged_decode_attention.launches}


def pinned_parity(torch, parity, gpu_line):
    """(a): the parity phase's fp32 model under each PINNED_SETTINGS,
    token-identical to the plain loop, K1/K3 where the route says; then
    PARITY_STEPS fp32 train steps at the flagship widths under "xla",
    "pallas" and "dpa"; then the raises that must not fall back."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops import multi_head_attention
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step

    prompts, want = parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    for label, impl, paged in PINNED_SETTINGS:
        cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                    param_dtype=torch.float32, remat=False,
                                    attn_impl=impl)
        model = Llama(cfg, device="cuda", seed=1)   # the parity model
        t0 = time.time()
        got, n = pinned_greedy(torch, model, prompts, paged)
        del model
        release(torch)
        print(f"pinned (a): {label}: greedy tokens equal to the plain loop "
              f"{got == want}; launches {json.dumps(n)}; "
              f"{time.time() - t0:.1f} s", flush=True)
        check(got == want, f"pinned (a): {label}: the engine's greedy "
                           f"tokens differ from the plain loop")
        k1, k3 = n["flash_fwd (K1)"], n["paged_decode (K3)"]
        if impl == "xla":
            check(k1 == 0 and k3 == 0, f"pinned (a): {label}: {n}")
        elif impl == "pallas":
            check(k1 > 0 and k3 > 0, f"pinned (a): {label}: {n}")
        elif impl == "dpa":
            check(k1 == 0, f"pinned (a): {label}: {n}")
        if impl != "auto":
            launches[f"pinned-{impl}"] = n

    tokens = np.random.RandomState(2).randint(0, FLAGSHIP["vocab_size"],
                                              (2, 257))
    rows = {}
    for impl in ("xla", "pallas", "dpa"):
        cfg = LlamaConfig(**dict(FLAGSHIP, n_layers=PINNED_TRAIN_LAYERS),
                          dtype=torch.float32, param_dtype=torch.float32,
                          attn_impl=impl)
        model = Llama(cfg, device="cuda", seed=2)
        batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1))(batch)
        zero_counters(fa)
        rows[impl] = []
        for _ in range(PARITY_STEPS):
            state, m = step(state, batch)
            rows[impl].append((float(m["loss"]), float(m["grad_norm"])))
        n = read_counters(fa)
        acc = launches[f"pinned-{impl}"]
        for k, v in n.items():
            acc[k] = acc.get(k, 0) + v
        print(f"pinned (a): train {impl}: (loss, grad_norm) "
              f"{[(round(a, 7), round(b, 7)) for a, b in rows[impl]]}; "
              f"launches {json.dumps(n)}", flush=True)
        k2 = n["flash_bwd_dq (K2a)"] + n["flash_bwd_dkv (K2b)"]
        if impl == "pallas":
            check(k2 > 0 and n["flash_fwd (K1)"] > 0,
                  f"pinned (a): train {impl}: launches {n}")
        else:
            check(k2 == 0 and n["flash_fwd (K1)"] == 0,
                  f"pinned (a): train {impl}: launches {n}")
        del model, state, step
        release(torch)
    worst = max(abs(a - b) / abs(b) for impl in ("pallas", "dpa")
                for g, x in zip(rows[impl], rows["xla"])
                for a, b in zip(g, x))
    print(f"pinned (a): train, {PARITY_STEPS} fp32 sgd steps of "
          f"{PINNED_TRAIN_LAYERS} flagship layers: pallas and dpa against "
          f"xla max relative difference {worst:.3g} (rtol {PARITY_RTOL})",
          flush=True)
    check(worst <= PARITY_RTOL, "pinned (a): the train steps of the "
                                "routes disagree")

    # raises: nothing falls back to the einsum path
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for label, shape, dt, impl, sk in (
            ("pallas at head dim 96", (1, 64, 32, 96), torch.float32,
             "pallas", 64),
            ("pallas in fp16", (1, 64, 32, 128), torch.float16, "pallas",
             64),
            ("dpa with Sq != Sk", (1, 1, 32, 128), torch.bfloat16, "dpa",
             64)):
        b, s, h, d = shape
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
        kv = torch.randn(b, sk, 8, d, generator=gen, device="cuda").to(dt)
        zero_counters(fa)
        try:
            multi_head_attention(q, kv, kv, causal=True, impl=impl)
            raised = None
        except (ValueError, TypeError) as e:
            raised = f"{type(e).__name__}: {e}"
        cases.append(label)
        print(f"pinned (a): {label}: raised {raised}", flush=True)
        check(raised is not None and fa.flash_attention_fwd.launches == 0,
              f"pinned (a): {label} did not raise")
    # the routes phase's Phi-3 widths through the model, pinned
    cfg = LlamaConfig(**ROUTE_CASES[0][1], n_layers=1, dtype=torch.float32,
                      param_dtype=torch.float32, attn_impl="pallas")
    model = Llama(cfg, device="cuda", seed=3)
    try:
        with torch.no_grad():
            model(torch.zeros(1, 16, dtype=torch.long, device="cuda"))
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"pinned (a): Phi-3 widths (head dim 96) pinned to pallas: "
          f"raised {raised}", flush=True)
    check(raised is not None, "pinned (a): head dim 96 under pallas ran")
    del model
    release(torch)
    return launches


def crossover(torch, gpu_line):
    """(b): one attention call at Llama-3-8B widths, bf16, causal, timed
    under each route at each CROSS_SEQS (forward) and CROSS_BWD_SEQS
    (forward plus backward); printed only."""
    from ray_tpu_torch.ops import multi_head_attention
    b, hq, hkv, d = CROSS_SHAPE
    table = []
    for s in CROSS_SEQS:
        gen = torch.Generator(device="cuda").manual_seed(s)
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        row = {"S": s}
        for impl in ("xla", "pallas", "dpa"):
            with torch.no_grad():
                row[f"fwd {impl}"] = time_ms(
                    lambda: multi_head_attention(q, k, v, causal=True,
                                                 impl=impl))
        if s in CROSS_BWD_SEQS:
            do = torch.randn(b, s, hq, d, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            for impl in ("xla", "pallas", "dpa"):
                def fwd_bwd():
                    qg.grad = kg.grad = vg.grad = None
                    multi_head_attention(qg, kg, vg, causal=True,
                                         impl=impl).backward(do)
                row[f"fwd+bwd {impl}"] = time_ms(fwd_bwd)
        table.append(row)
        print(f"crossover: {json.dumps({k: (round(x, 4) if k != 'S' else x) for k, x in row.items()})} "
              f"[{gpu_line}]", flush=True)
        del q, k, v
        release(torch)
    return table


def wf_model(torch):
    from ray_tpu_torch.models import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b(n_layers=WF_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16, remat=False)
    return Llama(cfg, device="cuda", seed=0)


def wf_embed(seed):
    """Step 1: a WF_SEQ-token prompt on the card and its embedding."""
    import torch
    model = wf_model(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, WF_SEQ),
                           device="cuda", generator=gen)
    with torch.no_grad():
        return {"tokens": tokens, "embed": model.token_embed(tokens)}


def wf_forward(embedded):
    """Step 2: the model's forward over the prompt (K1 once a layer); the
    stored embedding came back on this process's card."""
    import torch
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    model = wf_model(torch)
    tokens = embedded["tokens"]
    with torch.no_grad():
        same = bool(torch.equal(model.token_embed(tokens),
                                embedded["embed"]))
        before = fa.flash_attention_fwd.launches
        logits, _ = model(tokens)
        k1 = fa.flash_attention_fwd.launches - before
    return {"last": logits[0, -1], "k1": k1, "on_card": tokens.is_cuda,
            "embed_equal": same}


def wf_checksum(out, flag_path):
    """Step 3: the last row's checksum; raises while `flag_path` exists
    (the injected fault of (c)'s second workflow)."""
    if flag_path and os.path.exists(flag_path):
        raise RuntimeError("injected fault")
    return {"row": out["last"], "checksum": float(out["last"].double().sum()),
            "k1": out["k1"], "embed_equal": out["embed_equal"],
            "on_card": out["on_card"]}


WF_READER = r'''
import json, sys, torch
from ray_tpu_torch import workflow
workflow.init(sys.argv[1])
out = workflow.get_output(sys.argv[2])
row = out["row"]
print(json.dumps({"device": str(row.device), "dtype": str(row.dtype),
                  "checksum": float(row.double().sum()),
                  "hex": row.numpy().tobytes().hex(),
                  "cuda_initialized": torch.cuda.is_initialized()}))
'''


def workflows_on_the_card(torch, rt, root, gpu_line):
    """(c): a durable three-step DAG of num_gpus=1 steps whose last step
    raises on its first attempt: FAILED, then `resume` runs only that
    step; a rerun runs none; the output read in a process that sees no
    card."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    embed = rt.remote(num_gpus=1)(wf_embed)
    forward = rt.remote(num_gpus=1)(wf_forward)
    checksum = rt.remote(num_gpus=1)(wf_checksum)
    storage = os.path.join(root, "workflows")
    workflow.init(storage)
    flag = os.path.join(root, "wf-fail.flag")
    with InputNode() as inp:
        dag = checksum.bind(forward.bind(embed.bind(inp)), flag)

    def meta():
        return next(m for m in workflow.list_all()
                    if m["workflow_id"] == "wf-card")

    open(flag, "w").write("1")
    t0 = time.time()
    try:
        workflow.run(dag, workflow_id="wf-card", args=(7,))
        failed = None
    except Exception as e:  # noqa: BLE001 - the injected fault
        failed = repr(e)[:120]
    t_fail = time.time() - t0
    status = workflow.get_status("wf-card")
    os.unlink(flag)
    t0 = time.time()
    out = workflow.resume("wf-card", dag, args=(7,))
    t_resume = time.time() - t0
    mr = meta()
    t0 = time.time()
    again = workflow.run(dag, workflow_id="wf-card", args=(7,))
    t_again = time.time() - t0
    m = meta()
    res = subprocess.run(
        [sys.executable, "-c", WF_READER, storage, "wf-card"], cwd=HERE,
        env=front_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=FRONT_WAIT_S)
    check(res.returncode == 0, f"workflows (c): the reader failed:\n"
                               f"{res.stderr[-2000:]}")
    read = json.loads(res.stdout.strip().splitlines()[-1])
    row = out["row"]
    print(f"workflows (c): 3 num_gpus=1 steps (a {WF_SEQ}-token prompt "
          f"embedded, {WF_LAYERS} layers of the 8B widths bf16, the last "
          f"row's checksum {out['checksum']:.6f}); the first run, its "
          f"last step raising, {t_fail:.1f} s -> {status} ({failed}); "
          f"resume {t_resume:.2f} s ran {mr['steps_run']} and loaded "
          f"{mr['steps_skipped']}, K1 {out['k1']} in the forward step, the "
          f"stored embedding back on the step's card and equal "
          f"{out['embed_equal']}; a rerun in {t_again:.2f} s ran "
          f"{m['steps_run']} steps (loaded {m['steps_skipped']}), output "
          f"equal {torch.equal(again['row'], row)}; a reader with "
          f"CUDA_VISIBLE_DEVICES='' got {read['dtype']} on {read['device']}"
          f", bytes equal "
          f"{read['hex'] == row.cpu().numpy().tobytes().hex()}, CUDA "
          f"initialised {read['cuda_initialized']} [{gpu_line}]",
          flush=True)
    check(status == "FAILED" and failed is not None,
          f"workflows (c): the injected fault left {status}")
    check(mr["steps_run"] == 1 and mr["steps_skipped"] == 1,
          f"workflows (c): resume ran more than the failed step: {mr}")
    check(row.is_cuda and out["on_card"] and out["embed_equal"],
          "workflows (c): the steps' values did not come back on the card")
    check(out["k1"] == WF_LAYERS, f"workflows (c): K1 {out['k1']}")
    check(m["steps_run"] == 0 and torch.equal(again["row"], row)
          and again["checksum"] == out["checksum"],
          f"workflows (c): the rerun ran steps: {m}")
    check(read["device"] == "cpu" and not read["cuda_initialized"]
          and read["hex"] == row.cpu().numpy().tobytes().hex(),
          f"workflows (c): the card-less reader got {read['device']}, "
          f"CUDA initialised {read['cuda_initialized']}")
    return {"flash_fwd (K1)": out["k1"]}


class FracHolder:
    """A num_gpus=0.5 actor holding WF_LAYERS layers of the 8B widths."""

    def __init__(self):
        import torch
        self.model = wf_model(torch)
        gen = torch.Generator(device="cuda").manual_seed(11)
        self.tokens = torch.randint(0, self.model.cfg.vocab_size,
                                    (1, WF_SEQ), device="cuda",
                                    generator=gen)

    def ids(self):
        import ray_tpu_torch as rt
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    def forwards(self, n):
        import torch
        from ray_tpu_torch.ops.kernels import flash_attention as fa
        before = fa.flash_attention_fwd.launches
        t0 = time.time()
        with torch.no_grad():
            for _ in range(n):
                logits, _ = self.model(self.tokens)
        torch.cuda.synchronize()
        return {"start": t0, "end": time.time(),
                "k1": fa.flash_attention_fwd.launches - before,
                "finite": bool(torch.isfinite(logits).all())}


def fractional_gpus(torch, rt, gpu_line):
    """(d): two num_gpus=0.5 actors share card 0 and run at once; a third
    waits until one is killed; the GPU resource reads 0.0, 0.5, 1.0."""
    Half = rt.remote(num_gpus=0.5)(FracHolder)

    def free():
        return rt.available_resources().get("GPU", 0.0)

    def wait_free(n, timeout_s=60.0):
        deadline = time.time() + timeout_s
        while abs(free() - n) > 1e-9 and time.time() < deadline:
            time.sleep(0.1)
        return free()

    a, b = Half.remote(), Half.remote()
    ids = rt.get([a.ids.remote(), b.ids.remote()], timeout=FRONT_WAIT_S)
    free_two = wait_free(0.0)
    runs = rt.get([a.forwards.remote(FRAC_ITERS),
                   b.forwards.remote(FRAC_ITERS)], timeout=FRONT_WAIT_S)
    overlap = runs[0]["start"] < runs[1]["end"] \
        and runs[1]["start"] < runs[0]["end"]
    c = Half.remote()
    ref = c.ids.remote()
    ready, _ = rt.wait([ref], timeout=5.0)
    pending = not ready
    rt.kill(a)
    third = rt.get(ref, timeout=FRONT_WAIT_S)
    third_run = rt.get(c.forwards.remote(1), timeout=FRONT_WAIT_S)
    free_after = wait_free(0.0)
    rt.kill(b)
    free_half = wait_free(0.5)
    rt.kill(c)
    free_all = wait_free(1.0)
    print(f"fractional (d): two num_gpus=0.5 actors ({WF_LAYERS} layers of "
          f"the 8B widths bf16 each) ids {ids}, GPU free {free_two}; "
          f"{FRAC_ITERS} forwards of {WF_SEQ} tokens each at once: "
          f"overlapped {overlap}, {[round(r['end'] - r['start'], 3) for r in runs]} "
          f"s, K1 {[r['k1'] for r in runs]}; a third pending while both "
          f"held {pending}, then {third} once one was killed, K1 "
          f"{third_run['k1']}; GPU free {free_after} -> {free_half} -> "
          f"{free_all} [{gpu_line}]", flush=True)
    check(ids == [([0], "0"), ([0], "0")], f"fractional (d): ids {ids}")
    check(free_two == 0.0 and free_after == 0.0 and free_half == 0.5
          and free_all == 1.0, "fractional (d): the GPU resource readings")
    check(overlap and all(r["k1"] == WF_LAYERS * FRAC_ITERS and r["finite"]
                          for r in runs),
          f"fractional (d): the two actors' forwards {runs}")
    check(pending and third == ([0], "0") and third_run["k1"] == WF_LAYERS,
          "fractional (d): the third actor did not wait for a share")
    return {"flash_fwd (K1)": sum(r["k1"] for r in runs) + third_run["k1"]}


def phase_pinned_and_rest(torch, gpu_line, parity):
    """19. pinned routes and the rest: (a) and (b) in this process, then
    (c) and (d) in a runtime of their own. Returns the launches of the
    pinned routes, the workflow and the fractional actors."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    t_phase = time.time()
    launches = pinned_parity(torch, parity, gpu_line)
    crossover(torch, gpu_line)
    release(torch)
    free0, _ = torch.cuda.mem_get_info()
    root = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    rt.init()
    try:
        launches["workflow"] = workflows_on_the_card(torch, rt, root,
                                                     gpu_line)
        launches["fractional"] = fractional_gpus(torch, rt, gpu_line)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_no_workers("pinned routes and the rest")
    release(torch)
    front_memory_back(torch, free0, "pinned routes and the rest")
    print(f"pinned routes and the rest: phase wall "
          f"{time.time() - t_phase:.1f} s [{gpu_line}]", flush=True)
    return launches


# phase 20: parallelism, the rest. (a) the sp attention core on one card
# at Llama-3-8B attention widths, an 8192-token sequence in chunks;
# (b) the MoE dispatch at Mixtral-8x7B widths against the reference's
# one-hot formulation kept here; (c) the mesh paths at world n; (d) four
# cards only
SP_SHAPE = (1, 8192, 32, 8, 128)     # (a): B, S, Hq, Hkv, D, bf16, causal
SP_CHUNKS = 4
SP_LAUNCHES = 2 * SP_CHUNKS - 1      # K1, K2a, K2b: chunk 0 has no prefix
MOE_TOKENS, MOE_LAYERS = 4096, 2     # (b): tokens, bf16 MoE blocks
MOE_CF = 1.0                         # ... at which some tokens drop
# (b): both formulations cast the same expert products to bf16 from fp32
# sums of the same terms (the one-hot GEMM adds zeros): one bf16 ulp of
# the output beside a floor for the near-zero entries
MOE_ATOL, MOE_RTOL = 1e-2, 8e-3
SP_MESH_LAYERS, SP_MESH_STEPS = 2, 2  # (c): flagship layers, fp32 sgd steps
SP_MESH_ROWS, SP_MESH_SEQ = 2, 256
PPO_MESH_ITERS = 2                   # (c): PPO iterations each way
PPO_MESH_RTOL = 1e-5
FOUR_STEPS = 4                       # (d): the 8-layer sp step's steps,
FOUR_ROWS, FOUR_SEQ = 2, 8192        # ... at 2 x 8192 tokens
FOUR_GPT2_STEPS = 2                  # (d): GPT-2 small, fp32, tp 4
FOUR_MIX_ROWS, FOUR_MIX_SEQ = 4, 256  # (d): Mixtral over ep 2 x tp 2


def ulp_ratio(torch, got, want, atol, rtol):
    """(max |got - want|, its largest share of atol + rtol |want|)."""
    err = (got.float() - want.float()).abs()
    return (float(err.max()),
            float((err / (atol + rtol * want.float().abs())).max()))


def sp_chunks(torch, gpu_line):
    """(a): each chunk of SP_SHAPE's sequence through the split-prefix
    core (`sequence_parallel_attention`, route "pallas") against the
    whole K/V, forward and backward with a seeded dO, held against the
    plain versions on the same inputs as the kernels phase holds K1 and
    K2: the output against `flash_attention_plain`'s within K1's
    tolerance, dQ, dK and dV against `flash_bwd_dq_plain` and
    `flash_bwd_dkv_plain` fed the core's own (merged) lse and its delta
    within K2's. One K1 and one K2a/K2b call on the whole sequence is
    held against them the same way, and timed beside the chunks. The
    gradients of the plain versions from their own lse and delta are
    printed beside: there the bf16 outputs' roundings move delta, which
    no kernel decides. Returns the chunks' K1/K2a/K2b launches."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import sequence_parallel_attention
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    b, s, hq, hkv, d = SP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, do = (torch.randn((b, s, h, d), device="cuda", generator=gen,
                               dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    c = s // SP_CHUNKS

    def chunks():
        outs, dqs = [], []
        dk = torch.zeros(k.shape, dtype=torch.float32, device="cuda")
        dv = torch.zeros(v.shape, dtype=torch.float32, device="cuda")
        for r in range(SP_CHUNKS):
            qr = q[:, r * c:(r + 1) * c].contiguous().requires_grad_(True)
            kk, vv = k.detach().requires_grad_(True), \
                v.detach().requires_grad_(True)
            out = sequence_parallel_attention(qr, kk, vv, r, impl="pallas")
            out.backward(do[:, r * c:(r + 1) * c])
            outs.append(out.detach())
            dqs.append(qr.grad)
            dk += kk.grad.float()
            dv += vv.grad.float()
        return torch.cat(outs, 1), torch.cat(dqs, 1), dk, dv

    def whole():
        qw, kw, vw = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention(qw, kw, vw, causal=True)
        out.backward(do)
        return out.detach(), qw.grad, kw.grad, vw.grad

    def chunk_stats():
        """(lse, delta) (B*Hq, S) of the core, as its backward takes
        them: each chunk's parts merged (the forward's kernels again)."""
        outs, lses = [], []
        for r in range(SP_CHUNKS):
            qr = q[:, r * c:(r + 1) * c].contiguous()
            out, lse = attn._merge_parts([fa.flash_attention_fwd(
                qr, kk, vv, causal=causal) for kk, vv, causal, _ in
                attn._key_parts(k, v, r, c)], q.dtype)
            outs.append(out)
            lses.append(lse.view(b, hq, c))
        return (torch.cat(lses, 2).reshape(b * hq, s),
                fa.attention_delta(torch.cat(outs, 1), do))

    def plain(stats=None):
        """The plain versions, one kv head and its group of query heads
        at a time (heads are independent, and the (S, S) fp32 scores of
        all 32 heads would take 8 GiB a buffer); the backward from
        `stats` (lse, delta) where given, else from its own."""
        rep, parts = hq // hkv, []
        for j in range(hkv):
            heads = slice(j * rep, (j + 1) * rep)
            qg, dog = (t[:, :, heads].contiguous() for t in (q, do))
            kg, vg = (t[:, :, j:j + 1].contiguous() for t in (k, v))
            out, lse = fa.flash_attention_plain(qg, kg, vg, causal=True)
            delta = fa.attention_delta(out, dog)
            if stats is not None:
                lse, delta = (t.view(b, hq, s)[:, heads].reshape(b * rep, s)
                              for t in stats)
            parts.append((out, fa.flash_bwd_dq_plain(
                qg, kg, vg, dog, lse, delta, causal=True),
                *fa.flash_bwd_dkv_plain(qg, kg, vg, dog, lse, delta,
                                        causal=True)))
            del out, lse, delta
        return [torch.cat(t, 2) for t in zip(*parts)]

    zero_counters(fa)
    got = chunks()
    torch.cuda.synchronize()
    launches = read_counters(fa)
    whole_out, whole_lse = fa.flash_attention_fwd(q, k, v, causal=True)
    whole_stats = (whole_lse, fa.attention_delta(whole_out, do))
    del whole_out, whole_lse
    checks = [("out", K1_ATOL_OUT, K1_RTOL_OUT), ("dq", K2_ATOL, K2_RTOL),
              ("dk", K2_ATOL, K2_RTOL), ("dv", K2_ATOL, K2_RTOL)]

    def shares(have, want):
        return {name: ulp_ratio(torch, g, w, atol, rtol)
                for (name, atol, rtol), g, w in zip(checks, have, want)}

    def fmt(errs):
        return ", ".join(f"{n} {e:.4g} / {r:.3f}" for n, (e, r) in
                         errs.items())
    errs = shares(got, plain(chunk_stats()))
    own = shares(got, plain())
    release(torch)
    whole_errs = shares(whole(), plain(whole_stats))
    del whole_stats
    release(torch)
    t_chunks = time_ms(chunks, iters=5, warmup=1)
    t_whole = time_ms(whole, iters=5, warmup=1)
    print(f"phase 20: (a) sp attention core, B S Hq Hkv D = {SP_SHAPE} bf16 "
          f"causal in {SP_CHUNKS} chunks of {c} against the whole K/V "
          f"(split-prefix: K1 on the prefix and on the diagonal block, "
          f"merged by lse): max abs err / worst share of the tolerance "
          f"against the plain versions (backward from the core's lse and "
          f"delta): {fmt(errs)}; one whole-sequence K1 / K2 call against "
          f"them (from its own): {fmt(whole_errs)}; printed only, the "
          f"chunks against the plain backward from the plain lse and "
          f"delta: {fmt(own)}; launches {json.dumps(launches)}", flush=True)
    print(f"phase 20: (a) forward + backward, the {SP_CHUNKS} chunks "
          f"{t_chunks:.4f} ms in all, the whole call {t_whole:.4f} ms "
          f"(CUDA events, median) [{gpu_line}]", flush=True)
    for name, (_, ratio) in errs.items():
        check(ratio <= 1.0, f"phase 20 (a): the chunks' {name} differs from "
                            f"the plain version's")
    for name, (_, ratio) in whole_errs.items():
        check(ratio <= 1.0, f"phase 20 (a): the whole call's {name} differs "
                            f"from the plain version's")
    check(launches == {"flash_fwd (K1)": SP_LAUNCHES,
                       "flash_bwd_dq (K2a)": SP_LAUNCHES,
                       "flash_bwd_dkv (K2b)": SP_LAUNCHES},
          f"phase 20 (a): launches {launches}, want {SP_LAUNCHES} each")
    del q, k, v, do, got
    release(torch)
    return launches


def moe_onehot(torch, x, logits, expert_fn, k, c):
    """The reference's GShard dispatch (ray_tpu/ops/moe.py), kept as the
    check: one-hot (G, E, C) dispatch and combine tensors and einsums.
    Returns (out, kept (G, k) bool)."""
    import torch.nn.functional as F
    g, e = logits.shape
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
    weights = torch.softmax(top_logits[:, :k].float(), dim=-1)
    assign = F.one_hot(top_idx[:, :k], e).float()                # (G, k, E)
    slot_major = assign.transpose(0, 1).reshape(k * g, e).to(torch.int32)
    pos = (torch.cumsum(slot_major, 0, dtype=torch.int32) - slot_major
           ).reshape(k, g, e).transpose(0, 1)
    keep = assign * (pos < c)
    slot_pos = (pos * keep).sum(-1).long()
    cap = F.one_hot(slot_pos, c).float()                         # (G, k, C)
    dispatch = torch.einsum("gke,gkc->gec", keep, cap)
    combine = torch.einsum("gke,gk,gkc->gec", keep, weights, cap)
    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    expert_out = expert_fn(expert_in)
    out = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype),
                       expert_out)
    return out, keep.sum(-1) > 0


def moe_blocks(torch):
    """MOE_LAYERS MoE blocks of Mixtral-8x7B widths, bf16 weights from a
    seed (the router normal(0.02), the experts lecun-normal's scale)."""
    from ray_tpu_torch.models import MixtralConfig
    from ray_tpu_torch.models.mixtral import MoEMLP
    cfg = MixtralConfig.mixtral_8x7b(n_layers=MOE_LAYERS,
                                     dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16,
                                     capacity_factor=MOE_CF)
    gen = torch.Generator(device="cuda").manual_seed(21)
    blocks = []
    with torch.device("cuda"), torch.no_grad():
        for _ in range(MOE_LAYERS):
            moe = MoEMLP(cfg)
            for name, p in moe.named_parameters():
                std = 0.02 if "router" in name else p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                        * std)
            blocks.append(moe)
    return cfg, blocks


def moe_dispatch_phase(torch, gpu_line):
    """(b): MOE_LAYERS bf16 MoE blocks at Mixtral-8x7B widths on
    MOE_TOKENS tokens at capacity factor MOE_CF, each block on the index
    dispatch (the port's MoEMLP) and on the one-hot formulation from the
    same input: the same (token, slot)s kept, outputs within MOE_ATOL /
    MOE_RTOL; each formulation's time and peak memory over the blocks."""
    from ray_tpu_torch.ops.moe import expert_capacity, route
    from ray_tpu_torch.ops import swiglu
    cfg, blocks = moe_blocks(torch)
    k, e = cfg.experts_per_token, cfg.n_experts
    c = expert_capacity(MOE_TOKENS, e, k, MOE_CF)
    gen = torch.Generator(device="cuda").manual_seed(22)
    x0 = torch.randn((1, MOE_TOKENS, cfg.d_model), device="cuda",
                     generator=gen).to(cfg.dtype)

    def onehot_block(moe, x):
        tokens = x.reshape(-1, cfg.d_model)
        logits = tokens.float() @ moe.router_kernel.float()

        def expert_fn(batch):
            gate = torch.bmm(batch, moe.experts_gate_kernel)
            up = torch.bmm(batch, moe.experts_up_kernel)
            return torch.bmm(swiglu(gate, up), moe.experts_down_kernel)
        out, kept = moe_onehot(torch, tokens, logits, expert_fn, k, c)
        return out.reshape(x.shape).to(cfg.dtype), kept, logits

    def run(block_fn):
        x = x0
        for moe in blocks:
            x = x + block_fn(moe, x)
        return x

    worst, drops, same = 0.0, [], True
    with torch.no_grad():
        x = x0
        for moe in blocks:
            want, kept, logits = onehot_block(moe, x)
            got = moe(x)
            port = route(logits, k, c).keep
            same = same and bool(torch.equal(port, kept))
            drops.append(int((~kept).sum()))
            worst = max(worst, ulp_ratio(torch, got, want, MOE_ATOL,
                                         MOE_RTOL)[1])
            x = x + got
        stats = {}
        for label, fn in (("index", lambda moe, h: moe(h)),
                          ("one-hot", lambda moe, h: onehot_block(
                              moe, h)[0])):
            release(torch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run(fn)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            stats[label] = (time_ms(lambda: run(fn), iters=5, warmup=1),
                            extra / 2**20)
    print(f"phase 20: (b) MoE dispatch, Mixtral-8x7B widths (E {e}, k {k}, "
          f"d {cfg.d_model}, ff {cfg.d_ff}), {MOE_LAYERS} bf16 blocks on "
          f"{MOE_TOKENS} tokens, capacity factor {MOE_CF} (C {c}): (token, "
          f"slot)s dropped per block {drops}, the same as the one-hot "
          f"formulation's: {same}; worst share of the tolerance "
          f"{worst:.3f}", flush=True)
    print(f"phase 20: (b) the {MOE_LAYERS} blocks' forward: index dispatch "
          f"{stats['index'][0]:.4f} ms, peak {stats['index'][1]:.1f} MiB "
          f"above the weights and input; one-hot {stats['one-hot'][0]:.4f} "
          f"ms, peak {stats['one-hot'][1]:.1f} MiB [{gpu_line}]", flush=True)
    check(same, "phase 20 (b): the index dispatch drops other tokens than "
                "the one-hot formulation")
    check(sum(drops) > 0, f"phase 20 (b): capacity factor {MOE_CF} dropped "
                          f"no token")
    check(worst <= 1.0, "phase 20 (b): the index dispatch's output differs "
                        "from the one-hot formulation's")
    del blocks, x0
    release(torch)
    return {"flash_fwd (K1)": 0}


def sp_mesh_rank():
    """(c) on this rank: SP_MESH_STEPS fp32 sgd steps (TF32 off) of
    SP_MESH_LAYERS flagship layers under MeshSpec(sp=world) on a tokens
    batch (shifted, then cut over sp) against the same steps on one
    device (rank 0); then PPO_MESH_ITERS PPO iterations on the card with
    use_mesh=True (MeshSpec(dp=world)) and, on rank 0, with
    use_mesh=False, from the same seeds. Returns the metrics, the params'
    worst error, the mesh step's launches and the PPO stats."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.rllib import CartPole, PPOConfig
    from ray_tpu_torch.train import make_optimizer, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(sp=n), device="cuda")
    cfg = LlamaConfig(**{**FLAGSHIP, "n_layers": SP_MESH_LAYERS},
                      dtype=torch.float32, param_dtype=torch.float32)
    tokens = np.random.RandomState(23).randint(
        0, cfg.vocab_size, (SP_MESH_ROWS, SP_MESH_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    model = Llama(cfg, device="cuda", seed=23)
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=0.1), mesh)(batch)
    zero_counters(fa)
    rows_mesh = []
    for _ in range(SP_MESH_STEPS):
        state, m = step(state, batch)
        rows_mesh.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    launches = read_counters(fa)
    trained = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
               .detach() for k, v in model.state_dict().items()}

    def ppo(use_mesh):
        algo = (PPOConfig().environment(CartPole)
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=32)
                .training(num_epochs=2, minibatch_size=64,
                          use_mesh=use_mesh)
                .resources(device="cuda")).build()
        stats = [algo.train()["learner"] for _ in range(PPO_MESH_ITERS)]
        return stats, (None if algo.learner_group.mesh is None
                       else algo.learner_group.mesh.size())

    ppo_mesh, ppo_dp = ppo(True)
    out = {"mesh": rows_mesh, "launches": launches, "ppo_mesh": ppo_mesh,
           "ppo_dp": ppo_dp}
    if dist.get_rank() != 0:
        return out
    single = Llama(cfg, device="cuda", seed=23)
    sstate, sstep = make_train_step(single, make_optimizer(
        "sgd", learning_rate=0.1))(batch)
    rows_single = []
    for _ in range(SP_MESH_STEPS):
        sstate, m = sstep(sstate, batch)
        rows_single.append((float(m["loss"]), float(m["grad_norm"])))
    worst = 0.0
    for k, v in single.state_dict().items():
        err = (trained[k] - v).abs() - PARALLEL_ATOL
        worst = max(worst, float((err / v.abs().clamp(min=1e-30)).max()))
    out.update(single=rows_single, worst_rel=worst,
               ppo_plain=ppo(False)[0])
    return out


def sp_mesh_check(res, n, gpu_line):
    """(c): the mesh step against one device, launches on every rank,
    PPO over the mesh against PPO without it."""
    r0 = res[0]
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for g, c in zip(r0["mesh"], r0["single"]) for a, b in zip(g, c))
    print(f"phase 20: (c) flagship widths, {SP_MESH_LAYERS} fp32 layers (TF32 "
          f"off), MeshSpec(sp={n}), {SP_MESH_ROWS} x {SP_MESH_SEQ + 1} "
          f"tokens, {SP_MESH_STEPS} sgd steps: (loss, grad_norm) mesh "
          f"{r0['mesh']} one device {r0['single']}, within rtol "
          f"{PARITY_RTOL}: {ok}; params worst (|err| - {PARALLEL_ATOL}) / "
          f"|single| {r0['worst_rel']:.3g}; launches per rank "
          f"{[r['launches'] for r in res]}", flush=True)
    check(ok, "phase 20 (c): the sp mesh step's metrics differ from one "
              "device's")
    check(r0["worst_rel"] <= PARITY_RTOL,
          "phase 20 (c): the sp mesh step's params differ from one device's")
    for rank, r in enumerate(res):
        check(all(v > 0 for v in r["launches"].values()),
              f"phase 20 (c): rank {rank} launched {r['launches']}")
    worst, where = 0.0, None
    for i, (got, want) in enumerate(zip(r0["ppo_mesh"], r0["ppo_plain"])):
        for key, w in want.items():
            rel = abs(got[key] - w) / max(abs(w), 1e-12)
            if rel >= worst:
                worst, where = rel, (i, key, got[key], w)
    print(f"phase 20: (c) PPO on CartPole, {PPO_MESH_ITERS} iterations, "
          f"use_mesh=True (MeshSpec(dp={r0['ppo_dp']})) against "
          f"use_mesh=False: worst relative difference of the learner stats "
          f"{worst:.3g} (allowed {PPO_MESH_RTOL}), iteration {where[0]}'s "
          f"{where[1]} {where[2]!r} vs {where[3]!r} [{gpu_line}]",
          flush=True)
    check(r0["ppo_dp"] == n, f"phase 20 (c): PPO's learner group spans "
                             f"{r0['ppo_dp']} ranks, want {n}")
    check(worst <= PPO_MESH_RTOL, "phase 20 (c): PPO over the mesh differs "
                                  "from PPO without it")
    return r0["launches"]


def four_train_rank(n_layers, steps, gpu_line):
    """(d) on this rank: the train phase's model at n_layers under
    MeshSpec(fsdp=2, sp=2), FOUR_ROWS x FOUR_SEQ tokens: losses, the
    median step and peak memory."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     warmup_cosine)
    mesh = build_mesh(MeshSpec(fsdp=2, sp=dist.get_world_size() // 2),
                      device="cuda")
    cfg = LlamaConfig.llama3_8b(n_layers=n_layers, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (FOUR_ROWS, FOUR_SEQ + 1),
                                     device="cuda", generator=gen)}
    state, step = make_train_step(model, make_optimizer(
        "adamw", schedule=warmup_cosine(3e-4, 1, steps)), mesh)(batch)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.time()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.time() - t1)
    return {"losses": losses, "median_ms": statistics.median(times[1:]) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def four_gpt2_rank(path):
    """(d) on this rank: GPT-2 small (fp32, TF32 off) under
    MeshSpec(tp=4), FOUR_GPT2_STEPS sgd steps against one device's
    (rank 0), and its state saved sharded and restored onto one device
    bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import full_tensor
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     restore_pytree, save_pytree)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(MeshSpec(tp=dist.get_world_size()), device="cuda")
    cfg = GPT2Config.small(dtype=torch.float32)
    tokens = np.random.RandomState(24).randint(0, cfg.vocab_size, (4, 257))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}

    def run(model, mesh_):
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1), mesh_)(batch)
        rows = []
        for _ in range(FOUR_GPT2_STEPS):
            state, m = step(state, batch)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        return rows

    model = GPT2(cfg, device="cuda", seed=24)
    rows = run(model, mesh)
    save_pytree(model.state_dict(), path, step=FOUR_GPT2_STEPS)
    trained = {k: full_tensor(v).detach()
               for k, v in model.state_dict().items()}
    if dist.get_rank() != 0:
        return None
    restored = restore_pytree(path, map_location="cuda")
    single = run(GPT2(cfg, device="cuda", seed=24), None)
    return {"mesh": rows, "single": single, "bitwise": all(
        torch.equal(restored[k], trained[k]) for k in trained)}


def four_mixtral_rank():
    """(d) on this rank: Mixtral-8x7B widths at MOE_AUX_LAYERS fp32
    layers (TF32 off) under MeshSpec(ep=2, tp=2): one sgd step of the
    next-token loss on FOUR_MIX_ROWS x FOUR_MIX_SEQ tokens, each layer's
    router loss, against one device's (rank 0); peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import Mixtral, MixtralConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import make_optimizer, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(MeshSpec(ep=2, tp=dist.get_world_size() // 2),
                      device="cuda")
    cfg = MixtralConfig.mixtral_8x7b(n_layers=MOE_AUX_LAYERS,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32, remat=False)
    tokens = np.random.RandomState(25).randint(
        0, cfg.vocab_size, (FOUR_MIX_ROWS, FOUR_MIX_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}

    def run(mesh_):
        model = Mixtral(cfg, device="cuda", seed=25)
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1), mesh_)(batch)
        _, m = step(state, batch)
        aux = [float(b.moe.router_loss.detach()) for b in model.blocks]
        del state, step, model
        release(torch)
        return float(m["loss"]), aux

    torch.cuda.reset_peak_memory_stats()
    mesh_loss, mesh_aux = run(mesh)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if dist.get_rank() != 0:
        return None
    loss, aux = run(None)
    return {"mesh": (mesh_loss, mesh_aux), "single": (loss, aux),
            "peak_gib": peak_gib}


def four_cards(torch, gpu_line, run, parallel_ms):
    """(d): on four cards, the 8-layer train model on fsdp 2 x sp 2,
    GPT-2 small on tp 4 and Mixtral-8x7B widths on ep 2 x tp 2 ((c) ran
    PPO over dp 4)."""
    import shutil
    import tempfile
    out = run(four_train_rank, TRAIN_LAYERS, FOUR_STEPS, gpu_line)
    r0 = out[0]
    print(f"phase 20: (d) Llama-3-8B widths, {TRAIN_LAYERS} layers, "
          f"MeshSpec(fsdp=2, sp=2), {FOUR_ROWS} x {FOUR_SEQ} tokens, bf16 "
          f"compute, fp32 master, remat, adamw: losses "
          f"{[round(x, 6) for x in r0['losses']]}, median step "
          f"{r0['median_ms']:.1f} ms, peak memory a rank "
          f"{[round(o['peak_gib'], 2) for o in out]} GiB; parallel (a)'s "
          f"fsdp step here "
          f"{'not run' if parallel_ms is None else f'{parallel_ms:.1f} ms'}"
          f" [{gpu_line}]", flush=True)
    check(all(math.isfinite(x) for o in out for x in o["losses"]),
          "phase 20 (d): a non-finite loss on fsdp 2 x sp 2")
    root = tempfile.mkdtemp(prefix="chip_smoke_four_")
    try:
        g = run(four_gpt2_rank, os.path.join(root, "gpt2"))[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for x, y in zip(g["mesh"], g["single"]) for a, b in zip(x, y))
    print(f"phase 20: (d) GPT-2 small fp32 (TF32 off), MeshSpec(tp=4), "
          f"{FOUR_GPT2_STEPS} sgd steps: (loss, grad_norm) mesh {g['mesh']} "
          f"one device {g['single']}, within rtol {PARITY_RTOL}: {ok}; "
          f"its checkpoint restored onto one device bit for bit: "
          f"{g['bitwise']}", flush=True)
    check(ok and g["bitwise"], "phase 20 (d): GPT-2 under tp 4 differs from "
                               "one device")
    four_mixtral_check(run, gpu_line)


def four_mixtral_check(run, gpu_line):
    """(d): Mixtral-8x7B widths on ep 2 x tp 2 against one device."""
    m = run(four_mixtral_rank)[0]
    (ml, ma), (sl, sa) = m["mesh"], m["single"]
    worst = max(abs(a - b) / abs(b) for a, b in zip([ml] + ma, [sl] + sa))
    print(f"phase 20: (d) Mixtral-8x7B widths, {MOE_AUX_LAYERS} fp32 layers, "
          f"MeshSpec(ep=2, tp=2), {FOUR_MIX_ROWS} x {FOUR_MIX_SEQ} tokens: "
          f"loss {ml:.7f} vs one device {sl:.7f}, aux {ma} vs {sa}, worst "
          f"relative {worst:.3g} (allowed {MOE_AUX_RTOL}); peak memory "
          f"rank 0 {m['peak_gib']:.2f} GiB [{gpu_line}]", flush=True)
    check(worst <= MOE_AUX_RTOL, "phase 20 (d): Mixtral on ep 2 x tp 2 "
                                 "differs from one device")


def phase_parallel_rest(torch, gpu_line, parallel_ms):
    """20. parallelism, the rest: (a) the sp attention core in chunks,
    (b) the MoE dispatch against the one-hot formulation, (c) the sp
    mesh step and PPO over a dp mesh at world n (at n == 1 a world of
    one NCCL rank in this process), (d) four cards only. Returns the
    launches of (a), (b) and (c)."""
    from ray_tpu_torch.train.backend import launch
    t_phase = time.time()
    n = torch.cuda.device_count()
    launches = {"sp-chunks": sp_chunks(torch, gpu_line),
                "moe-dispatch": moe_dispatch_phase(torch, gpu_line)}

    def run(fn, *args):
        return launch(fn, n, "cuda", *args, timeout_s=900, spawn=n > 1)

    # a world of one takes the plain step and learner: not sp's launches
    key = "sp-mesh" if n > 1 else "mesh-of-one"
    launches[key] = sp_mesh_check(run(sp_mesh_rank), n, gpu_line)
    release(torch)
    if n >= 4 and n % 2 == 0:
        four_cards(torch, gpu_line, run, parallel_ms)
    else:
        print(f"phase 20: four-card part not run: {n} card(s)", flush=True)
    print(f"phase 20: parallelism, the rest: phase wall "
          f"{time.time() - t_phase:.1f} s [{gpu_line}]", flush=True)
    return launches


# phase 21: the experts in FSDP2 (an (fsdp, ep) mesh of their own). (a)
# this machine's torch in a world of 4 gloo CPU ranks, as the CPU tests
# run it: a small Mixtral on each EXPERTS_SPECS mesh against one device;
# (b) the card: Mixtral-8x7B widths at EXPERTS_MESH_LAYERS fp32 layers
# (TF32 off, the published capacity factor) in a world of n ranks, on
# MeshSpec(fsdp=2, ep=n // 2) where n >= 4 cards, else on MeshSpec(ep=n)
# (at n == 1 every axis is 1: the degenerate mesh)
EXPERTS_CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, n_experts=4, experts_per_token=2,
                   max_seq_len=64, capacity_factor=1.0)
EXPERTS_STEPS = 3
EXPERTS_SPECS = (dict(fsdp=2, ep=2), dict(ep=2, tp=2), dict(fsdp=2, tp=2))
EXPERTS_MESH_LAYERS, EXPERTS_MESH_STEPS = 2, 2
EXPERTS_MESH_ROWS, EXPERTS_MESH_SEQ = 2, 256   # rows a data rank


def table_shard(name, shape, sizes):
    """The shard of one rank under the port's copy of the reference's
    table (`partition_spec_for`) on a mesh of these axis sizes."""
    from ray_tpu_torch.parallel.sharding import partition_spec_for
    spec = partition_spec_for(name, tuple(shape), sizes)
    out = list(shape)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[i] //= sizes.get(axis, 1)
    return out


def experts_fsdp_check(gpu_line):
    """(a): Mixtral (EXPERTS_CFG) on each of EXPERTS_SPECS in one world of
    4 gloo CPU ranks, under this machine's torch, against EXPERTS_STEPS
    fp32 sgd steps on one device: metrics and params within PARITY_RTOL
    (beside PARALLEL_ATOL); each expert a DTensor in FSDP2 on fsdp and
    the axes that split it, its shard the table's, gathered whole over
    d when its layer's forward starts."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import Mixtral, MixtralConfig
    from ray_tpu_torch.parallel import _testing
    from ray_tpu_torch.train import make_optimizer, make_train_step
    from ray_tpu_torch.train.backend import launch
    cfg = MixtralConfig(**EXPERTS_CFG, dtype=torch.float32,
                        param_dtype=torch.float32)
    model = Mixtral(cfg, device="cpu", seed=24)
    params = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(24)
    batches = [{"tokens": rng.randint(0, cfg.vocab_size, (8, 17))}
               for _ in range(EXPERTS_STEPS)]
    cases = [dict(model="mixtral", cfg=EXPERTS_CFG, spec=spec, opt="sgd",
                  lr=0.1, batches=batches, params=params)
             for spec in EXPERTS_SPECS]
    got_all = launch(_testing.run_jobs, 4, "cpu", [("train_cases", cases)],
                     timeout_s=300)[0][0]
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=0.1))(tb[0])
    want = []
    for b in tb:
        state, m = step(state, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    for spec, got in zip(EXPERTS_SPECS, got_all):
        sizes = {a: spec.get(a, 1) for a in ("dp", "fsdp", "ep", "sp",
                                             "tp", "pp")}
        have = [(r["loss"], r["grad_norm"]) for r in got["metrics"]]
        ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
                 for g, w in zip(have, want) for a, b in zip(g, w))
        worst = max(float(((np.abs(got["params"][k] - v.numpy())
                            - PARALLEL_ATOL) / np.abs(v.numpy()).clip(1e-12))
                           .max()) for k, v in model.state_dict().items())
        experts = [k for k in got["params"] if ".experts_" in k]
        dims = ["fsdp"] + [a for a in ("ep", "tp") if sizes[a] > 1]
        table = all(got["local_shape"][k] == table_shard(
            k, got["params"][k].shape, sizes) for k in experts)
        placed = all(got["mesh_dims"][k] == dims for k in experts)
        gathered = all(got["at_forward"][k] == table_shard(
            k, got["params"][k].shape, {**sizes, "fsdp": 1})
            for k in experts)
        shares = sorted({got["local_numel"][k] / got["params"][k].size
                         for k in experts})
        print(f"phase 21: (a) FSDP2 of torch {torch.__version__}: Mixtral "
              f"(E 4, d 64, ff 128) on MeshSpec({spec}) in 4 gloo CPU "
              f"ranks, {EXPERTS_STEPS} fp32 sgd steps: (loss, grad_norm) "
              f"mesh {have} one device {want}, within rtol {PARITY_RTOL}: "
              f"{ok}; params worst (|err| - {PARALLEL_ATOL}) / |single| "
              f"{worst:.3g}; the experts on {dims} ({placed}), "
              f"{got['placements'][experts[0]]} for {experts[0]}, each "
              f"rank's shard the table's {table}, a share {shares} of "
              f"each; whole over d at the layer's forward {gathered}; the "
              f"exchange on the experts' ep group "
              f"{got['ep_group_is_experts']} [{gpu_line}]", flush=True)
        check(ok and worst <= PARITY_RTOL, f"phase 21 (a): Mixtral on "
                                           f"{spec} differs from one device")
        check(placed and table and gathered,
              f"phase 21 (a): the experts' layout on {spec}")
        check(got["ep_group_is_experts"] in (None, True),
              f"phase 21 (a): the ep exchange's group on {spec}")


def experts_mesh_rank(spec):
    """(b) on this rank: Mixtral-8x7B widths (fp32, TF32 off) on
    MeshSpec(**spec) in a world of cards: the experts' placement (mesh
    dims, placements, local shapes against the table's shard, bytes a
    rank), EXPERTS_MESH_STEPS sgd steps with K1/K2a/K2b counted, peak
    memory; on rank 0 the same steps on one device and the params'
    worst error."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.models import Mixtral, MixtralConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.collectives import data_size
    from ray_tpu_torch.parallel.sharding import axis_sizes, full_tensor
    from ray_tpu_torch.train import make_optimizer, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(MeshSpec(**spec), device="cuda")
    sizes = axis_sizes(mesh)
    cfg = MixtralConfig.mixtral_8x7b(n_layers=EXPERTS_MESH_LAYERS,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32, remat=False)
    tokens = np.random.RandomState(26).randint(0, cfg.vocab_size, (
        EXPERTS_MESH_ROWS * data_size(mesh), EXPERTS_MESH_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    torch.cuda.reset_peak_memory_stats()
    model = Mixtral(cfg, device="cuda", seed=26)
    whole = sum(p.numel() * p.element_size()
                for n, p in model.named_parameters() if ".experts_" in n)
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=0.1), mesh)(batch)
    layout, held = {}, 0
    for name, p in model.named_parameters():
        if ".experts_" not in name:
            continue
        local = p.to_local() if isinstance(p, DTensor) else p
        held += local.numel() * local.element_size()
        layout[name] = {
            "dims": list(p.device_mesh.mesh_dim_names)
            if isinstance(p, DTensor) else None,
            "placements": repr(tuple(p.placements))
            if isinstance(p, DTensor) else None,
            "local": list(local.shape),
            "table": table_shard(name, p.shape, sizes)}
    zero_counters(fa)
    rows = []
    for _ in range(EXPERTS_MESH_STEPS):
        state, m = step(state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    launches = read_counters(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trained = {k: full_tensor(v).detach()
               for k, v in model.state_dict().items()}
    del state, step, model
    out = {"mesh": rows, "launches": launches, "layout": layout,
           "held": held, "whole": whole, "peak_gib": peak_gib}
    if dist.get_rank() != 0:
        del trained
        release(torch)
        return out
    release(torch)
    single = Mixtral(cfg, device="cuda", seed=26)
    sstate, sstep = make_train_step(single, make_optimizer(
        "sgd", learning_rate=0.1))(batch)
    rows_single = []
    for _ in range(EXPERTS_MESH_STEPS):
        sstate, m = sstep(sstate, batch)
        rows_single.append((float(m["loss"]), float(m["grad_norm"])))
    worst = 0.0
    for k, v in single.state_dict().items():
        err = (trained[k] - v).abs() - PARALLEL_ATOL
        worst = max(worst, float((err / v.abs().clamp(min=1e-30)).max()))
    del sstate, sstep, single, trained
    release(torch)
    out.update(single=rows_single, worst_rel=worst)
    return out


def phase_experts_fsdp(torch, gpu_line):
    """21. the experts in FSDP2: (a) the layouts in 4 gloo CPU ranks, (b)
    the Mixtral step on the cards through K1/K2a/K2b, after K1 and K2 are
    held against their plain versions at its attention's shape. Returns
    (b)'s launches (rank 0's; every rank's are checked)."""
    from ray_tpu_torch.train.backend import launch
    t_phase = time.time()
    experts_fsdp_check(gpu_line)
    t_a = time.time() - t_phase
    n = torch.cuda.device_count()
    spec = dict(fsdp=2, ep=n // 2) if n >= 4 and n % 2 == 0 else dict(ep=n)
    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = (EXPERTS_MESH_ROWS, EXPERTS_MESH_SEQ, True, 32, 8, 128)
    k1_check(torch, gen, *shape, "float32")
    k2_check(torch, gen, *shape, torch.float32)
    release(torch)
    res = launch(experts_mesh_rank, n, "cuda", spec, timeout_s=900,
                 spawn=n > 1)
    r0 = res[0]
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for g, c in zip(r0["mesh"], r0["single"]) for a, b in zip(g, c))
    dims = ["fsdp"] + [a for a in ("ep", "tp") if spec.get(a, 1) > 1]
    if dims == ["fsdp"]:
        dims.append("ep")                 # the degenerate mesh keeps ep
    name = next(iter(r0["layout"]))
    gib = 2.0**30
    split = spec.get("ep", 1) * spec.get("tp", 1)
    print(f"phase 21: (b) Mixtral-8x7B widths, {EXPERTS_MESH_LAYERS} fp32 "
          f"layers (TF32 off), MeshSpec({spec}) on {n} card(s), "
          f"{EXPERTS_MESH_ROWS} x {EXPERTS_MESH_SEQ + 1} tokens a data "
          f"rank, {EXPERTS_MESH_STEPS} sgd steps: (loss, grad_norm) mesh "
          f"{r0['mesh']} one device {r0['single']}, within rtol "
          f"{PARITY_RTOL}: {ok}; params worst (|err| - {PARALLEL_ATOL}) / "
          f"|single| {r0['worst_rel']:.3g}; {name} on "
          f"{r0['layout'][name]['dims']} {r0['layout'][name]['placements']}"
          f", local {r0['layout'][name]['local']} (the table's "
          f"{r0['layout'][name]['table']}); experts a rank "
          f"{[round(r['held'] / gib, 3) for r in res]} GiB of "
          f"{r0['whole'] / gib:.3f} (whole over d, as before this layout: "
          f"{r0['whole'] / split / gib:.3f}); peak memory a rank "
          f"{[round(r['peak_gib'], 2) for r in res]} GiB; launches per rank "
          f"{[r['launches'] for r in res]} [{gpu_line}]", flush=True)
    check(ok, "phase 21 (b): the Mixtral mesh step's metrics differ from "
              "one device's")
    check(r0["worst_rel"] <= PARITY_RTOL,
          "phase 21 (b): the Mixtral mesh step's params differ from one "
          "device's")
    want = EXPERTS_MESH_LAYERS * EXPERTS_MESH_STEPS
    for rank, r in enumerate(res):
        check(all(v["dims"] == dims and v["local"] == v["table"]
                  for v in r["layout"].values()),
              f"phase 21 (b): rank {rank}'s experts {r['layout']}")
        check(r["launches"] == {"flash_fwd (K1)": want,
                                "flash_bwd_dq (K2a)": want,
                                "flash_bwd_dkv (K2b)": want},
              f"phase 21 (b): rank {rank} launched {r['launches']}")
    print(f"phase 21: the experts in FSDP2: phase wall "
          f"{time.time() - t_phase:.1f} s ((a) {t_a:.1f} s) [{gpu_line}]",
          flush=True)
    return r0["launches"]


def check_spills(build) -> None:
    """Registers and spills of the wgmma kernels (K1's forward, K2a's and
    K2b's backward at D 64 and 128) and of every K4 kernel, from the
    `-Xptxas -v` logs written beside the loaded builds of flash_fwd.cu,
    flash_bwd.cu and rmsnorm.cu; a missing log, a missing kernel, any
    spill, or ptxas serialising wgmma (advisories C7514/C7515: the
    products no longer overlap the code between them) fails."""
    import re
    pat = re.compile(r"Function properties for (\S*wgmma\S*)\n\s*(\d+) bytes "
                     r"stack frame, (\d+) bytes spill stores, (\d+) bytes "
                     r"spill loads\n.*?Used (\d+) registers")
    for lib, want in (("flash_fwd", 2), ("flash_bwd", 4)):
        path = build.log_path(lib)
        check(os.path.exists(path), f"no build log {path} for the loaded "
                                    f"{lib} library")
        with open(path) as f:
            log = f.read()
        found = pat.findall(log)
        serial = sorted(set(re.findall(r"\(C751[45]\)[^\n]*?function "
                                       r"'(\S+)'", log)))
        check(not serial, f"ptxas serialises wgmma in {lib}: {serial}")
        for name, _, stores, loads, regs in found:
            kernel = re.search(r"(\w+_wgmma_kernel)ILi(\d+)", name)
            print(f"build: {kernel.group(1)}<{kernel.group(2)}> {regs} "
                  f"registers at launch, spill stores {stores} B, loads "
                  f"{loads} B", flush=True)
        check(len(found) == want, f"ptxas log of {lib} lists {len(found)} "
                                  f"wgmma kernels, want {want}")
        check(all(int(st) == 0 and int(ld) == 0 for _, _, st, ld, _ in found),
              f"a wgmma kernel of {lib} spills registers")
    # K4: every function of the library, the ring kernel's nine
    # instantiations (three x types by three weight types) among them
    path = build.log_path("rmsnorm")
    check(os.path.exists(path), f"no build log {path} for the loaded "
                                f"rmsnorm library")
    with open(path) as f:
        log = f.read()
    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads\n.*?Used (\d+) registers", log)
    ring = [regs for name, _, _, regs in found if "ring_kernel" in name]
    print(f"build: rmsnorm {len(found)} kernels, ring kernel registers at "
          f"launch {sorted(set(map(int, ring)))}, spill bytes "
          f"{sum(int(st) + int(ld) for _, st, ld, _ in found)}", flush=True)
    check(len(ring) == 9, f"ptxas log of rmsnorm lists {len(ring)} ring "
                          f"kernels, want 9")
    check(all(int(st) == 0 and int(ld) == 0 for _, st, ld, _ in found),
          "a kernel of rmsnorm spills registers")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch", "csrc")):
        fail("run from a checkout of the repository: ray_tpu_torch/ is "
             "missing beside this script")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(f"gpu: {gpu_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    build.build_all()
    print(f"build: {', '.join(build.sources())} in {time.time() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    check_spills(build)

    rows = phase_kernels(torch)
    launches, serve_stats = phase_serve(torch, gpu_line)
    parity = phase_parity(torch)
    phase_controls(torch)
    phase_routes(torch)
    launches.update(phase_zoo(torch, gpu_line))
    launches["train"], train_stats = phase_train(torch, gpu_line)
    launches["trainer"] = phase_trainer(torch, gpu_line, train_stats)
    phase_trainer_resume(torch)
    phase_train_parity(torch)
    launches.update(phase_grpo(torch, gpu_line))
    launches["north-star-grpo"] = phase_north_star(torch)
    launches["parallel"], parallel_ms = phase_parallel(torch, gpu_line,
                                                       train_stats)
    launches["runtime-trainer"], rank_ms = phase_runtime(torch, gpu_line,
                                                        train_stats)
    launches.update(phase_serve_deploy(torch, gpu_line, serve_stats, parity))
    launches["data-trainer"] = phase_data(torch, gpu_line, rank_ms)
    launches["tune"], tune_want = phase_tune(torch, gpu_line)
    launches.update(phase_front_doors(torch, gpu_line, parity,
                                      tune_want[FRONT_JOB_LR]))
    launches.update(phase_pinned_and_rest(torch, gpu_line, parity))
    launches.update(phase_parallel_rest(torch, gpu_line, parallel_ms))
    launches["experts-fsdp"] = phase_experts_fsdp(torch, gpu_line)
    check_graphs()

    # each kernel's launches on the main paths (the serve bursts, train,
    # GRPO full, LoRA, the north star's and the mesh train step, the
    # pinned routes, the workflow and the fractional actors, the sp
    # chunks, the sp mesh step, the MoE dispatch and the Mixtral step
    # with its experts in FSDP2); K4 is on none: no model calls it, as
    # in the reference
    for r in rows:
        by_path = {p: n[r["name"]] for p, n in launches.items()
                   if r["name"] in n}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows, "gpu": gpu_line}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
