"""Training: the LM train step, its state and trainer, and the VWW train
step; port of `repro.train`."""
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import StragglerMonitor, Trainer

__all__ = ["TrainState", "make_train_step", "Trainer", "StragglerMonitor"]
