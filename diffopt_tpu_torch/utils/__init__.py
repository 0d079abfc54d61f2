"""Configuration, precision guard and test-data helpers of the port."""

from .config import DiffOptConfig, get_config, set_config, use_config
from .precision import full_precision
from . import batching

__all__ = ["DiffOptConfig", "get_config", "set_config", "use_config", "full_precision", "batching"]
