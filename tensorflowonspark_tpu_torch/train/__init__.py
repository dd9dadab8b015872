"""Training-plane modules of the port: the trainer (:mod:`.trainer`) and
its loop ``Trainer.fit``, losses (:mod:`.losses`), checkpoints
(:mod:`.checkpoint`), device prefetch (:mod:`.prefetch`), metrics, the
tfevents codec and the HTTP serving surface (:mod:`.metrics`,
:mod:`.tbevents`)."""

from tensorflowonspark_tpu_torch.train import losses  # noqa: F401
from tensorflowonspark_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
)
