"""Training-plane modules of the port. This slice carries only the HTTP
serving surface (:mod:`.metrics`); the trainer is a later slice."""
