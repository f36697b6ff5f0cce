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
                   (tokenize_dataset, hf_dataset_to_ray)
  lora.py          LoRA adapters over a frozen base (sharded on a mesh),
                   make_lora_train_step
  utils.py         prepare_module (a model onto a mesh),
                   prepare_loader (a rank's Dataset shard as device
                   batches), iter_batches_sharded
  trainer.py       TorchTrainer (the reference's JaxTrainer): a training
                   loop on rank actors, with reports, checkpoints and
                   FailureConfig restarts
  session.py       report / get_context / TrainContext inside the loop
  multihost.py     MultiHostSpmd: a torch.distributed world of rank
                   actors (run, run_async, run_sharded, reform)
  elastic.py       GangSupervisor, reshard_mesh_spec
  spmd_trainer.py  ElasticSpmdTrainer: SpmdTrainer on a supervised gang
                   that reforms and restores when a rank dies

SpmdTrainer itself needs no runtime: it runs in each rank of `launch` or
in a world of one.
"""
from . import adapters  # noqa: F401  (transformers only inside a call)
from .backend import (TorchBackendConfig, detect_rank, detect_world_size,
                      form_mesh, launch, setup_worker, worker_env)
from .checkpoint import (Checkpoint, CheckpointManager, restore_pytree,
                         save_pytree)
from .config import (CheckpointConfig, FailureConfig, RunConfig,
                     ScalingConfig)
from .elastic import GangSupervisor, reshard_mesh_spec
from .lora import (DEFAULT_TARGETS, LoraConfig, init_lora, lora_param_count,
                   make_lora_train_step, merge_lora)
from .optim import make_optimizer, warmup_cosine
from .result import Result
from .spmd import SpmdStep, TrainState, make_train_step, next_token_loss
from .multihost import MultiHostSpmd
from .session import TrainContext, get_context, report
from .spmd_trainer import ElasticSpmdTrainer, SpmdTrainer, SpmdTrainerConfig
from .trainer import TorchTrainer
from .utils import prepare_loader, prepare_module

__all__ = ["adapters", "TrainState", "SpmdStep", "make_train_step",
           "next_token_loss", "TorchBackendConfig", "setup_worker",
           "form_mesh", "worker_env", "detect_rank", "detect_world_size",
           "launch", "prepare_module", "prepare_loader",
           "make_optimizer", "warmup_cosine", "Checkpoint",
           "CheckpointManager", "save_pytree", "restore_pytree",
           "LoraConfig", "init_lora", "merge_lora", "lora_param_count",
           "make_lora_train_step", "DEFAULT_TARGETS", "ScalingConfig",
           "RunConfig", "FailureConfig", "CheckpointConfig", "Result",
           "SpmdTrainer", "SpmdTrainerConfig", "reshard_mesh_spec",
           "TorchTrainer", "report", "get_context", "TrainContext",
           "MultiHostSpmd", "GangSupervisor", "ElasticSpmdTrainer"]
