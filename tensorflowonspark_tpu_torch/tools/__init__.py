"""Command-line tools of the port.

* :mod:`~tensorflowonspark_tpu_torch.tools.agent` — one host's executor
  agent for a driver's
  :class:`~tensorflowonspark_tpu_torch.backend_remote.RemoteBackend`
  (``python -m tensorflowonspark_tpu_torch.tools.agent --driver host:port``);
* :mod:`~tensorflowonspark_tpu_torch.tools.model_export` — checkpoint to
  export directory;
* :mod:`~tensorflowonspark_tpu_torch.tools.inference` — TFRecords in, JSON
  predictions out, through ``pipeline.TFModel``;
* :mod:`~tensorflowonspark_tpu_torch.tools.generate` — export or
  checkpoint in, LM continuations out;
* :mod:`~tensorflowonspark_tpu_torch.tools.reservation_client` — STOP a
  running rendezvous server.

The loading tools take ``--device`` (default ``cuda``; ``cpu`` runs on the
host).
"""

import logging

LOG_FORMAT = "%(asctime)s %(levelname)s (%(threadName)s-%(process)d) %(message)s"


def setup_logging(level=logging.INFO):
    """Process-wide logging with thread/pid context, for the tools' entry
    points (the JAX package's ``setup_logging``)."""
    logging.basicConfig(level=level, format=LOG_FORMAT)
