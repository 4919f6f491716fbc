"""Device choice of the port's entry points: the GPU unless the caller asks
for the CPU.  Nothing falls back: without a GPU the default raises."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device(device); raises where a CUDA device is asked for (the
    default) and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"coslam_tpu_torch runs on the GPU by default, but device "
            f"{str(dev)!r} was requested and torch.cuda.is_available() is "
            f'False; pass device="cpu" to run on the CPU')
    return dev
