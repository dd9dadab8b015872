"""PyTorch/CUDA port of :mod:`tensorflowonspark_tpu` for NVIDIA Hopper.

The package grows slice by slice beside the JAX package, which stays the
reference. Module names mirror the JAX package (``models/transformer.py``,
``ops/paged_attention.py``, ``serving/runner.py``, ...) so each port sits
where a reader expects its counterpart. The port imports ``torch`` and
numpy only: nothing of ``jax`` and nothing of ``tensorflowonspark_tpu``,
whose framework-free modules it keeps its own copies of.

Entry points (``ServingEngine``, ``generate``, ``get_model``) run on
the card by default (``device="cuda"``) and raise when no card is present
unless the caller asks for ``device="cpu"``. Every TPU kernel on a ported
path is a hand-written CUDA kernel under ``csrc/``; its plain PyTorch
version runs only for tensors that lie on the CPU.
"""
