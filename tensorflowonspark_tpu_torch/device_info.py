"""Device resolution and the card's identity (port of ``device_info``).

The JAX package reads TPU topology hints; the port's counterpart resolves
the ``device=`` argument every entry point takes and reports which card it
runs on. Peak numbers come from the card's name and NVIDIA's data sheets;
on the CPU, or on a card this table does not know, they are ``None`` —
never a guess, so a roofline against a made-up ceiling is never printed.
"""

import torch

# Dense peaks of the SXM part (NVIDIA H100 data sheet): HBM bytes/s and
# operations/s by operand type. CUDA-core f32 is the rate a kernel that
# does not use the tensor cores is bound by.
_H100_SXM = {
    "bytes_per_sec": 3.35e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "fp8": 1979e12,
    "int8": 1979e12,
    "f32": 67e12,
}


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device=`` argument.

    ``"cuda"`` (the default everywhere) requires a card: with none present
    this raises instead of quietly running on the CPU. ``"cpu"`` is an
    explicit request and always resolves."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device={!r} but no CUDA device is available; pass "
            "device='cpu' to run on the CPU".format(str(device)))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got {!r}".format(
            str(device)))
    return dev


def card(index=0):
    """``{"name", "capability", "count"}`` of CUDA device ``index``, or
    None when no card is present."""
    if not torch.cuda.is_available():
        return None
    return {
        "name": torch.cuda.get_device_name(index),
        "capability": torch.cuda.get_device_capability(index),
        "count": torch.cuda.device_count(),
    }


def _peaks(index=0):
    info = card(index)
    if info is None or "H100" not in info["name"] or "PCIe" in info["name"]:
        return None
    return _H100_SXM


def peak_bandwidth(index=0):
    """Device-memory bytes/s of the card, or None (CPU, unknown card)."""
    peaks = _peaks(index)
    return None if peaks is None else peaks["bytes_per_sec"]


def peak_ops(kind, index=0):
    """Dense operations/s of the card for operand ``kind`` (``"bf16"``,
    ``"f32"``, ``"int8"``, ...), or None (CPU, unknown card)."""
    peaks = _peaks(index)
    return None if peaks is None else peaks.get(kind)
