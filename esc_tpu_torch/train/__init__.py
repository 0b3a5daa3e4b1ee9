"""Training and evaluation: data, optimizer, evaluation sweep, trainer."""

from .data import (DataLoader, EvalSet, load_wav, make_dataloader,
                   quantization_dropout, save_wav)
from .evaluate import eval_epoch
from .optim import make_optimizer, make_schedule
from .trainer import Trainer

__all__ = ["DataLoader", "EvalSet", "load_wav", "save_wav",
           "make_dataloader", "quantization_dropout", "eval_epoch",
           "make_optimizer", "make_schedule", "Trainer"]
