"""K8 project: the per-Gaussian stage of an inference render, from a model's
stored tensors to the blend table and the expansion table in one pass.

The JAX package has no kernel here: its preprocess, SH and activation are
plain XLA.  Their twin in the port is the plain chain
``StoredGaussians.activated`` -> ``preprocess`` -> ``blend_fields`` ->
``build_table``, which ``project_table_plain`` runs; ``project_table`` runs
it for CPU tensors and launches ``csrc/project.cu`` for CUDA tensors, whose
every output equals the twin's bit for bit.  ``ops.rasterize.project`` takes
this route for stored tensors in a render without autograd and without a
debug hook.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gaussian_splatting_torch import _kernels
from gaussian_splatting_torch.ops import expand as ex
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops.blend import NUM_FIELDS
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.ops.sh import MAX_DEGREE, num_sh_coeffs


class StoredGaussians(NamedTuple):
    """A model's pre-activation tensors, as ``GaussianModel.stored`` hands
    them to the rasterizer, and its active SH degree."""

    means3d: torch.Tensor  # (P, 3)
    scales: torch.Tensor  # (P, 3) log-scales
    quats: torch.Tensor  # (P, 4) wxyz, not normalised
    opacities: torch.Tensor  # (P,) logits
    alive: torch.Tensor  # (P,) bool
    features_dc: torch.Tensor  # (P, 1, 3)
    features_rest: torch.Tensor  # (P, K - 1, 3)
    sh_degree: int  # active degree

    def activated(self):
        """Rasterizer inputs: (means, scales, unit quats, opacities, sh) with
        SH coefficients above the active degree zeroed and dead slots at
        opacity 0 (JAX ``train/loop.py::_activated_params``)."""
        sh = torch.cat([self.features_dc, self.features_rest], dim=1)
        K = sh.shape[1]
        degs = torch.floor(
            torch.sqrt(torch.arange(K, dtype=torch.float32, device=sh.device))
        ).to(torch.int32)
        sh = torch.where((degs <= self.sh_degree)[None, :, None], sh, 0.0)
        q = self.quats
        return (
            self.means3d,
            torch.exp(self.scales),
            q / torch.sqrt((q * q).sum(dim=-1, keepdim=True)),
            torch.sigmoid(self.opacities) * self.alive,
            sh,
        )


def project_table(
    gaussians: StoredGaussians, cam: CameraParams, *, sh_degree: int, tile_w: int = 16,
    tile_h: int = 16, scale_modifier: float = 1.0, antialiasing: bool = False,
) -> inst.ProjectedTable:
    """The blend table, radii and expansion table of ``gaussians`` seen by
    ``cam``, with SH evaluated at ``sh_degree``.  CPU tensors run the plain
    twin; CUDA tensors launch the kernel."""
    g = gaussians
    if g.means3d.device.type == "cpu":
        return project_table_plain(
            g, cam, sh_degree=sh_degree, tile_w=tile_w, tile_h=tile_h,
            scale_modifier=scale_modifier, antialiasing=antialiasing)
    P, rest_k = g.means3d.shape[0], g.features_rest.shape[1]
    _check_inputs(g, cam, sh_degree, P, rest_k)
    dev = g.means3d.device
    radii = torch.empty(P, dtype=torch.int32, device=dev)
    incl, fields, x0, y0, rect_w, flag, span_x0, span_cum, depth_key = _outputs(P, dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _kernels.launch(
        "project", "gs_project", [vp] * 10 + [ci] * 9 + [cf] * 5 + [vp] * 11,
        *(t.data_ptr() for t in g[:7]),
        cam.viewmatrix.data_ptr(), cam.projmatrix.data_ptr(), cam.campos.data_ptr(),
        P, rest_k, sh_degree, g.sh_degree, int(antialiasing), cam.width, cam.height,
        tile_w, tile_h,
        # Python floats, rounded to float32 as PyTorch rounds a scalar operand
        float(scale_modifier), 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy, cam.focal_x,
        cam.focal_y,
        fields.data_ptr(), radii.data_ptr(), x0.data_ptr(), y0.data_ptr(), rect_w.data_ptr(),
        flag.data_ptr(), span_x0.data_ptr(), span_cum.data_ptr(), depth_key.data_ptr(),
        incl.data_ptr(), _kernels.current_stream(dev),
    )
    # 0 and the slot counts, summed in place into build_table's offsets
    incl.cumsum_(0)
    table = ex.ExpandTable(offsets=incl.to(torch.int32), rect_x0=x0, rect_y0=y0,
                           rect_w=rect_w, span_flag=flag, span_x0=span_x0,
                           span_cum=span_cum, depth_key=depth_key)
    return inst.ProjectedTable(fields=fields, radii=radii, table=table, total=incl[-1])


def _check_inputs(g: StoredGaussians, cam: CameraParams, sh_degree: int, P: int, rest_k: int):
    _kernels.check_cuda("project", *g[:7], cam.viewmatrix, cam.projmatrix, cam.campos)
    if not 0 <= sh_degree <= MAX_DEGREE or num_sh_coeffs(sh_degree) > rest_k + 1:
        raise ValueError(f"project: SH degree {sh_degree} outside the model's coefficients")
    shapes = ((P, 3), (P, 3), (P, 4), (P,), (P,), (P, 1, 3), (P, rest_k, 3))
    if any(t.shape != s for t, s in zip(g[:7], shapes)):
        raise ValueError("project: the stored tensors' shapes do not match")
    if g.alive.dtype != torch.bool or any(t.dtype != torch.float32 for t in g[:4] + g[5:7]):
        raise ValueError("project: stored tensors must be float32, alive bool")


def _outputs(P: int, device):
    """K8's outputs but the radii, as views of one allocation, each on a
    16-byte boundary: the (P + 1,) int64 offsets, the (P, 10) blend table,
    the expansion table's rect_x0, rect_y0, rect_w, span_flag, span_x0,
    span_cum (int32) and depth_key (float32)."""
    rows = ex.MAX_SPAN_ROWS
    sizes = []  # in 4-byte words, each part followed by its padding
    for words in (2 * (P + 1), NUM_FIELDS * P, P, P, P, P, rows * P, rows * P, P):
        sizes += [words, -words % 4]
    block = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    incl, fields, x0, y0, rect_w, flag, span_x0, span_cum, depth = block.split(sizes)[::2]
    return (incl.view(torch.int64), fields.view(torch.float32).view(P, NUM_FIELDS), x0, y0,
            rect_w, flag, span_x0.view(P, rows), span_cum.view(P, rows),
            depth.view(torch.float32))


def project_table_plain(
    gaussians: StoredGaussians, cam: CameraParams, *, sh_degree: int, tile_w: int = 16,
    tile_h: int = 16, scale_modifier: float = 1.0, antialiasing: bool = False,
) -> inst.ProjectedTable:
    """The kernel's twin: the plain chain, on any device."""
    from gaussian_splatting_torch.ops.rasterize import blend_fields, table_of  # imports this

    proj = preprocess(*gaussians.activated(), cam, sh_degree=sh_degree, tile_w=tile_w,
                      tile_h=tile_h, scale_modifier=scale_modifier, antialiasing=antialiasing)
    return table_of(proj, blend_fields(proj))
