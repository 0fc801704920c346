from .optim import build_optimizer, lr_at_epoch, set_learning_rate
from .steps import build_eval_step, build_train_step, dice_stats
from .trainer import (
    SemiTrainer,
    UDATrainer,
    IICTrainer,
    UDAIICTrainer,
    resolve_device,
    trainer_zoos,
)

__all__ = [
    "build_optimizer",
    "lr_at_epoch",
    "set_learning_rate",
    "build_eval_step",
    "build_train_step",
    "dice_stats",
    "SemiTrainer",
    "UDATrainer",
    "IICTrainer",
    "UDAIICTrainer",
    "resolve_device",
    "trainer_zoos",
]
