"""The trainer, which lives in `parallel/trainer.py` as in the JAX package
(one class for one card and for several); re-exported here for the
training loop's imports."""

from ..parallel.trainer import Trainer, _lazy_adam, _set_trainable  # noqa: F401
