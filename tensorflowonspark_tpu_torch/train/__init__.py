"""Training-plane modules of the port: the trainer (:mod:`.trainer`), its
losses (:mod:`.losses`) and the HTTP serving surface (:mod:`.metrics`).
``Trainer.fit`` with device prefetch and asynchronous metrics is ROADMAP
A4b, checkpointing A5."""

from tensorflowonspark_tpu_torch.train import losses  # noqa: F401
from tensorflowonspark_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
)
