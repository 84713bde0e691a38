"""The LM harness's training side, in PyTorch: AdamW, the train steps (one
device, data-parallel ranks, the cross-pod step), int8 cross-pod
compression and atomic checkpoints.  Counterpart of ``repro.train``, less
``shard_map_compat`` (a shim over JAX versions)."""
from .checkpoint import (latest_step, restore_checkpoint, restore_latest,
                         save_checkpoint)
from .compression import crosspod_mean, crosspod_mean_int8, init_error_feedback
from .optimizer import (OptConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt)
from .step import grads_and_loss, make_train_step, make_train_step_crosspod

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "restore_latest",
    "save_checkpoint",
    "crosspod_mean",
    "crosspod_mean_int8",
    "init_error_feedback",
    "OptConfig",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt",
    "grads_and_loss",
    "make_train_step",
    "make_train_step_crosspod",
]
