"""Command-line tools of the port.

* :mod:`~tensorflowonspark_tpu_torch.tools.agent` — one host's executor
  agent for a driver's
  :class:`~tensorflowonspark_tpu_torch.backend_remote.RemoteBackend`
  (``python -m tensorflowonspark_tpu_torch.tools.agent --driver host:port``).
"""
