"""The device the port's entry points run on: the CUDA card, unless the caller names one.

`SlamPipeline`, `GraphBasedSLAM`, `make_fused_frontend` and the CLI (`--device`) take a
`device`; when it is None they use `default_device()`, which is the card and raises when
there is none. Nothing falls back to the CPU: a run on the CPU is asked for by name.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card; raises RuntimeError when torch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is False. The port runs on the card "
            "by default; pass device='cpu' (the CLI: --device cpu) to run on the CPU.")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, `default_device()` when None. A CUDA device is refused
    with the same error as the default when there is no card."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device
