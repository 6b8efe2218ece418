"""PyTorch + CUDA port of ``gaussian_splatting_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference each module is held
against; this package imports neither JAX nor anything from it.  Module file
names mirror the JAX package's so each counterpart is easy to find.

Every hand-written kernel lives in ``csrc/`` and is built by ``_kernels.py``
on first use.  Each kernel wrapper runs its plain PyTorch twin when given CPU
tensors (the tests) and launches the kernel, or raises, on CUDA tensors.
Entry points default to ``device="cuda"`` and raise when no card is present.
"""

from __future__ import annotations

import torch

# Full float32 everywhere: the JAX reference runs its small matrix products
# (e.g. the exposure affine) at HIGHEST precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises rather than running on the CPU when
    no card is present and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
