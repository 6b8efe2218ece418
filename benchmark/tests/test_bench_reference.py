"""The reference against the port's CPU path at 64x48 and 800 Gaussians:
the render within 2e-4 (relative to the image's norm), integer outputs
equal, and each parameter group's gradient within 3e-4 of its largest
entry."""

import copy
import math

import pytest
import torch

from benchmark import harness as hn
from benchmark import scenes
from benchmark.reference import render as rr
from benchmark.reference import train as rt

W, H, FOCAL = 64, 48, 52.0


def small_scene(seed):
    spec = hn.load_spec()
    cfg = copy.deepcopy(hn.config_of(spec, hn.find(spec["workloads"], "m360_outdoor_train", "c")))
    cfg["num_gaussians"] = 800
    state = scenes.gaussians(cfg, seed, "cpu", 1000, alive_first=False)
    state.update(scenes.optimizer_state(state, cfg, seed, "cpu"))
    a = cfg["assumed"]
    q, t = scenes.ring_poses(8, a["ring_radius"], a["ring_height"])[seed % 8]
    return cfg, state, q, t


def port_camera(q, t):
    from gaussian_splatting_torch.ops.camera_math import make_camera

    fov = 2 * math.atan(W / (2 * FOCAL)), 2 * math.atan(H / (2 * FOCAL))
    return make_camera(rr.qvec_to_rotmat(q).T, t, *fov, W, H, device="cpu")


def port_model(state):
    from gaussian_splatting_torch.models.gaussians import GaussianModel

    return GaussianModel(**{k: state[k].clone() for k in scenes.PARAM_NAMES},
                         alive=state["alive"].clone(), max_sh_degree=3, sh_degree=3,
                         spatial_lr_scale=4.4,
                         stats={k: state[k].clone() for k in scenes.STAT_NAMES})


@pytest.mark.parametrize("seed", [3, 2147483659])
def test_render_matches_port(seed):
    from gaussian_splatting_torch.ops.rasterize import render

    _, state, q, t = small_scene(seed)
    params = {k: state[k] for k in scenes.PARAM_NAMES}
    bg = torch.zeros(3)
    with torch.no_grad():
        out = render(*port_model(state).activated_params(), port_camera(q, t), bg, sh_degree=3,
                     inference=True)
    image, invd, geo, bins = rr.view(params, state["alive"], rr.camera(q, t, FOCAL, FOCAL, W, H,
                                                                       "cpu"), bg, 3)
    assert float((out.image - image).norm() / image.norm()) <= 2e-4
    assert float((out.invdepth - invd).norm() / invd.norm()) <= 2e-4
    assert torch.equal(out.radii.long(), geo.radii)
    assert int(out.num_instances) == bins.demand


@pytest.mark.parametrize("seed", [5, 3100000019])
def test_step_gradients_match_port(seed):
    from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
    from gaussian_splatting_torch.train.optim import adam_init
    from gaussian_splatting_torch.train.step import StepBatch, TrainState, step_gradients

    _, state, q, t = small_scene(seed)
    gt = torch.rand(3, H, W, generator=torch.Generator().manual_seed(seed)) * 0.8 + 0.1
    model = port_model(state)
    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)[None]
    ps = TrainState(model=model, adam=adam_init({k: v.detach() for k, v in model.params().items()}),
                    exposures=eye, exp_adam=adam_init({"exposures": eye}),
                    step=torch.tensor(15000, dtype=torch.int32))
    batch = StepBatch(gt_image=gt, alpha_mask=torch.ones(1, H, W), invdepth_gt=torch.zeros(H, W),
                      depth_mask=torch.zeros(H, W), exposure_idx=torch.tensor(0),
                      bg_color=torch.zeros(3))
    g = step_gradients(ps, port_camera(q, t), batch, opt=OptimizationConfig(),
                       raster=RasterizeConfig(instance_slack=8.0))
    ref = {k: v.clone() for k, v in state.items()}
    ref["step"] = ref["count"] = torch.tensor(15000)
    info = rt.step(ref, rr.camera(q, t, FOCAL, FOCAL, W, H, "cpu"), gt, torch.zeros(3), 4.4)
    assert abs(float(g.loss) - info["loss"]) <= 1e-5 * info["loss"]
    for k in scenes.PARAM_NAMES:
        alive = state["alive"].reshape((-1,) + (1,) * (g.params[k].dim() - 1))
        mine, theirs = g.params[k] * alive, info["grads"][k]
        scale = float(theirs.abs().max())
        assert float((mine - theirs).abs().max()) <= 3e-4 * scale, k
