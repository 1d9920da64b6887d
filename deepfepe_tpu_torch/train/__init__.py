"""Configuration and the evaluation step."""

from .config import Config, config_from_dict, load_config
from .engine import compute_losses, eval_step

__all__ = ["Config", "compute_losses", "config_from_dict", "eval_step", "load_config"]
