"""coslam_tpu_torch — the PyTorch / CUDA port of `coslam_tpu`.

The JAX package `coslam_tpu/` is the reference; this package mirrors its
layout module for module (`coslam_tpu/<path>` -> `coslam_tpu_torch/<path>`)
and never imports jax.  Plain tensor code is PyTorch; every Pallas kernel of
the reference (`coslam_tpu/ops/pallas_kernels.py`) is a hand-written CUDA
kernel under `csrc/`, bound in `ops/cuda_kernels.py` with a plain PyTorch
twin that runs for CPU tensors.

Ported so far: localization-mode tracking — resume a saved map
(`utils/checkpoint.py`), `System.activate_localization_mode`,
`System.run_sequence` (models/system.py).
"""

__version__ = "0.1.0"

import torch as _torch

# Full float32 everywhere, mirroring coslam_tpu/__init__.py's f32-HIGHEST
# default: descriptor bits need ~0.1 intensity accuracy (ops/orb.py), which
# TF32's 10-bit mantissa does not give.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from coslam_tpu_torch.config import (  # noqa: E402,F401
    CameraConfig,
    ExtractorConfig,
    LoopConfig,
    MapperConfig,
    MatcherConfig,
    SystemConfig,
    TrackerConfig,
)
