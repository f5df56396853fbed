"""Training of the port: AdamW, the train step and loop, checkpoints and
gradient compression (counterpart of ``repro/train``)."""

from repro_torch.train.checkpoint import latest_step, restore_checkpoint, retain_last, save_checkpoint
from repro_torch.train.compression import compress_grads, init_error_state
from repro_torch.train.loop import FailureInjector, TrainState, make_train_step, train_loop
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "schedule",
    "TrainState",
    "make_train_step",
    "train_loop",
    "FailureInjector",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "retain_last",
    "compress_grads",
    "init_error_state",
]
