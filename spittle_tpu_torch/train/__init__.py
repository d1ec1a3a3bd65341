"""Fine-tuning (port of spittle_tpu/train): the train step, SpecAugment and
checkpoints."""

from .step import cross_entropy_loss, make_train_step

__all__ = ["cross_entropy_loss", "make_train_step"]
