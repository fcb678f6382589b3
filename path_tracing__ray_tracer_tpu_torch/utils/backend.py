"""Backend probing (port of the JAX package's ``utils/backend.py``).

The JAX package falls back to the CPU when its TPU backend fails to
initialize, as the reference falls back to its CPU renderer without CUDA
(``main.py:11-20``).  The port does not: its renderers run their CUDA
kernels on the card, and a run that asked for the card and has none fails
here, rather than rendering on the CPU through the kernels' plain versions.
The CPU is taken only when the caller asks for it.
"""
from __future__ import annotations

from .logging import log_event


def probe_backend(device="cuda") -> str:
    """The backend the renderers will run on, ``"cuda"`` or ``"cpu"``;
    logs the card's name.  Raises ``RuntimeError`` when ``device`` is a
    CUDA device and torch sees no card."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        log_event("backend_probe", platform="cpu", requested=str(device))
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"probe_backend: no renderer runs on device {device!r}")
    if not torch.cuda.is_available():
        log_event("backend_probe_failed", requested=str(device), error="no CUDA device")
        raise RuntimeError(
            f"probe_backend: device {device!r} asked for, but torch sees no CUDA device "
            "(pass device='cpu' to render on the CPU)")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    log_event("backend_probe", platform="cuda", device_count=torch.cuda.device_count(),
              device=torch.cuda.get_device_name(index))
    return "cuda"
