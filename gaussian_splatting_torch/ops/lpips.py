"""LPIPS perceptual metric with a VGG16 backbone.

Counterpart of ``gaussian_splatting_tpu/ops/lpips.py``: normalised VGG16
feature stacks of the two images compared per slice, weighted by the learned
linear heads, averaged over space and summed over the five slices.

The weights are carried across from the JAX package unchanged: both packages
read the same ``.npz`` file, with the VGG16 convolutions as
``features.N.weight`` / ``.bias`` (OIHW, torchvision's layout) and the heads
as ``lin{i}.model.1.weight``.  No weights ship with the repository and none
can be fetched, so the metric is gated as in JAX: ``metrics`` takes
``--lpips_weights``, then ``$GS_LPIPS_WEIGHTS``, then
``~/.cache/gs_lpips_vgg16.npz``, and reports LPIPS as null without a file.
The JAX module's docstring has the recipe that exports the file.

The weights go to the device once, when the module is built.  TF32 stays
off (package ``__init__``), so the convolutions run in full float32 on the
card as on the CPU.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussian_splatting_torch import resolve_device

# VGG16 convolution indices in torchvision's ``features`` module, grouped into
# the 5 LPIPS slices (ending at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG16_SLICES = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
EPS = 1e-10


class LPIPS(nn.Module):
    """LPIPS(a, b) for two (H, W, 3) images in [0, 1], as one batch of 2."""

    def __init__(self, weights: Mapping[str, np.ndarray], device=None):
        super().__init__()
        dev = resolve_device(device)

        def conv(lid):
            w = torch.from_numpy(np.asarray(weights[f"features.{lid}.weight"], np.float32))
            b = torch.from_numpy(np.asarray(weights[f"features.{lid}.bias"], np.float32))
            layer = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], padding=1)
            with torch.no_grad():
                layer.weight.copy_(w)
                layer.bias.copy_(b)
            return layer

        self.slices = nn.ModuleList(
            nn.ModuleList(conv(lid) for lid in ids) for ids in VGG16_SLICES)
        for si in range(len(VGG16_SLICES)):
            head = np.asarray(weights[f"lin{si}.model.1.weight"], np.float32)
            self.register_buffer(f"head{si}", torch.from_numpy(head.reshape(-1, 1, 1)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))
        self.requires_grad_(False)
        self.to(dev)

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.stack([a, b]).permute(0, 3, 1, 2) * 2.0 - 1.0
        x = (x - self.shift) / self.scale
        total = x.new_zeros(())
        for si, convs in enumerate(self.slices):
            for layer in convs:
                x = F.relu(layer(x))
            f = x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + EPS)
            diff = (f[0] - f[1]) ** 2
            total = total + torch.mean(torch.sum(diff * getattr(self, f"head{si}"), dim=0))
            if si < len(self.slices) - 1:
                # 2x2, stride 2, odd sizes floored: JAX's VALID reduce_window
                x = F.max_pool2d(x, 2, 2)
        return total


def make_lpips(weights_path: str, device=None) -> Callable:
    """lpips(render_hwc, gt_hwc) -> float from an ``.npz`` weights file;
    the images are (H, W, 3) arrays or tensors in [0, 1].  Runs on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    with np.load(weights_path) as raw:
        net = LPIPS(dict(raw), device=dev)

    def fn(a, b) -> float:
        ta = torch.as_tensor(a, dtype=torch.float32, device=dev)
        tb = torch.as_tensor(b, dtype=torch.float32, device=dev)
        return float(net(ta, tb))

    return fn
