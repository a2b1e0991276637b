from .server import BatchServer, ServeResult
from .trainer import Trainer, TrainerConfig

__all__ = ["BatchServer", "ServeResult", "Trainer", "TrainerConfig"]
