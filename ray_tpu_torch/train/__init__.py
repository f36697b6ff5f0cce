"""ray_tpu_torch.train — training (counterpart of ray_tpu/train/).

Layer map:
  spmd.py          the train step, on one device or on a mesh (SpmdStep),
                   TrainState, next_token_loss
  spmd_trainer.py  SpmdTrainer: declarative model+mesh trainer (the
                   step, the device loader, logging, checkpoints, resume)
  elastic.py       reshard_mesh_spec
  backend.py       the per-rank process group, form_mesh, and `launch`,
                   which runs a function in every rank of a local world
  optim.py         optimizers that follow optax step for step,
                   warmup_cosine
  checkpoint.py    atomic torch.save checkpoints (sharded trees gathered
                   to rank 0, restored onto any mesh shard by shard),
                   CheckpointManager
  config.py        ScalingConfig/RunConfig/FailureConfig/CheckpointConfig
  result.py        Result
  adapters.py      HF weight import (GPT-2, Llama) + tokenizer glue
  lora.py          LoRA adapters over a frozen base (sharded on a mesh),
                   make_lora_train_step
  utils.py         prepare_module (a model onto a mesh),
                   iter_batches_sharded

SpmdTrainer needs no runtime: it runs in each rank of `launch` or in a
world of one. JaxTrainer, the multihost and elastic gangs
(GangSupervisor, ElasticSpmdTrainer), the sessions and the dataset
adapters need the runtime's actors and wait for a later slice.
"""
from . import adapters  # noqa: F401  (transformers only inside a call)
from .backend import (TorchBackendConfig, detect_rank, detect_world_size,
                      form_mesh, launch, setup_worker, worker_env)
from .checkpoint import (Checkpoint, CheckpointManager, restore_pytree,
                         save_pytree)
from .config import (CheckpointConfig, FailureConfig, RunConfig,
                     ScalingConfig)
from .elastic import reshard_mesh_spec
from .lora import (DEFAULT_TARGETS, LoraConfig, init_lora, lora_param_count,
                   make_lora_train_step, merge_lora)
from .optim import make_optimizer, warmup_cosine
from .result import Result
from .spmd import SpmdStep, TrainState, make_train_step, next_token_loss
from .spmd_trainer import SpmdTrainer, SpmdTrainerConfig
from .utils import prepare_module

__all__ = ["adapters", "TrainState", "SpmdStep", "make_train_step",
           "next_token_loss", "TorchBackendConfig", "setup_worker",
           "form_mesh", "worker_env", "detect_rank", "detect_world_size",
           "launch", "prepare_module",
           "make_optimizer", "warmup_cosine", "Checkpoint",
           "CheckpointManager", "save_pytree", "restore_pytree",
           "LoraConfig", "init_lora", "merge_lora", "lora_param_count",
           "make_lora_train_step", "DEFAULT_TARGETS", "ScalingConfig",
           "RunConfig", "FailureConfig", "CheckpointConfig", "Result",
           "SpmdTrainer", "SpmdTrainerConfig", "reshard_mesh_spec"]
