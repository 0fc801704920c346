from .checkpoints import lenient_load_checkpoint, load_checkpoint, save_checkpoint
from .optim import build_optimizer, init_optimizer_state, lr_at_epoch, set_learning_rate
from .steps import build_eval_step, build_train_step, dice_stats
from .trainer import (
    SemiTrainer,
    UDATrainer,
    IICTrainer,
    UDAIICTrainer,
    EntropyMinTrainer,
    MeanTeacherTrainer,
    resolve_device,
    trainer_zoos,
)

__all__ = [
    "lenient_load_checkpoint",
    "load_checkpoint",
    "save_checkpoint",
    "build_optimizer",
    "init_optimizer_state",
    "lr_at_epoch",
    "set_learning_rate",
    "build_eval_step",
    "build_train_step",
    "dice_stats",
    "SemiTrainer",
    "UDATrainer",
    "IICTrainer",
    "UDAIICTrainer",
    "EntropyMinTrainer",
    "MeanTeacherTrainer",
    "resolve_device",
    "trainer_zoos",
]
