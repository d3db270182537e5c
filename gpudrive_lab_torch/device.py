"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

# JAX's platform names (the JAX CLIs' --platform values) and the torch
# device type each means here
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def platform_device(name: str) -> torch.device:
    """The device a ``--device``/``--platform`` value names: JAX's platform
    names ``cpu``, ``gpu`` and ``cuda`` are the CPU and CUDA, any other
    string ``torch.device`` parses (``cuda:1``) is that device, and ``tpu``
    raises: the port runs on CUDA or the CPU."""
    if name == "tpu":
        raise ValueError("--platform tpu: the port runs on CUDA (gpu, cuda, "
                         "cuda:N) or the CPU (cpu), not on a TPU")
    return torch.device(PLATFORMS.get(name, name))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another (a ``torch.device`` or a name ``platform_device`` reads).
    Raises when CUDA is asked for (explicitly or by default) and none is
    present; there is no silent fallback to the CPU."""
    device = "cuda" if device is None else device
    dev = (platform_device(device) if isinstance(device, str)
           else torch.device(device))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
