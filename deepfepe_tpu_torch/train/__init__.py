"""Configuration, the train and eval steps, and the training loop."""

from .config import Config, config_from_dict, load_config, qt_clamps
from .engine import compute_losses, eval_step, learning_rate, make_optimizer, train_step
from .loop import MetricLogger, Trainer, load_checkpoint, save_checkpoint

__all__ = ["Config", "MetricLogger", "Trainer", "compute_losses", "config_from_dict",
           "eval_step", "learning_rate", "load_checkpoint", "load_config", "make_optimizer",
           "qt_clamps", "save_checkpoint", "train_step"]
