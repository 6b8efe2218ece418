"""Scene container: dataset cameras + the Gaussian model's lifecycle.

Counterpart of ``gaussian_splatting_tpu/scene.py``.  With
``load_iteration=None`` (training) the Scene copies the dataset's point
cloud to ``input.ply``, writes ``cameras.json``, and builds a new model with
``create_from_pcd``; otherwise it loads that iteration's ``point_cloud.ply``
(-1: the latest).  ``shuffle`` calls ``random.shuffle`` on the train and then
the test camera infos, as JAX does, so under one ``random.seed`` both
packages see the cameras in the same order.  ``save`` writes a snapshot.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.config import ModelConfig
from gaussian_splatting_torch.data.cameras import Camera, camera_to_json, load_camera
from gaussian_splatting_torch.data.dataset import SceneInfo, detect_and_load_scene
from gaussian_splatting_torch.data.ply import save_gaussian_ply
from gaussian_splatting_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
    create_from_pcd,
    load_model_ply,
)
from gaussian_splatting_torch.parallel.mesh import is_main_process


class Scene:
    def __init__(
        self,
        cfg: ModelConfig,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        capacity: Optional[int] = None,
        device=None,
    ):
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.device = resolve_device(device)
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                pc_dir = os.path.join(self.model_path, "point_cloud")
                load_iteration = max(
                    int(d.split("_")[-1])
                    for d in os.listdir(pc_dir)
                    if d.startswith("iteration_")
                )
            self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info: SceneInfo = detect_and_load_scene(
            cfg.source_path,
            images=cfg.images,
            depths=cfg.depths,
            eval_split=cfg.eval,
            white_background=cfg.white_background,
        )
        if not self.loaded_iter and self.model_path and is_main_process():
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c)
                        for i, c in enumerate(info.train_cameras + info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)
        if shuffle:
            random.shuffle(info.train_cameras)
            random.shuffle(info.test_cameras)
        self.cameras_extent = info.nerf_normalization["radius"]

        kw = dict(resolution=cfg.resolution, white_background=cfg.white_background,
                  train_test_exp=cfg.train_test_exp, is_synthetic=info.is_nerf_synthetic,
                  device=self.device)
        print("Loading Training Cameras")
        self.train_cameras = [load_camera(ci, exposure_idx=i, **kw)
                              for i, ci in enumerate(info.train_cameras)]
        print("Loading Test Cameras")
        self.test_cameras = [load_camera(ci, **kw) for ci in info.test_cameras]

        if self.loaded_iter:
            self.gaussians = load_model_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}", "point_cloud.ply"),
                max_sh_degree=cfg.sh_degree, capacity=capacity, device=self.device,
            )
            self.gaussians.spatial_lr_scale = float(self.cameras_extent)
        else:
            self.gaussians = create_from_pcd(
                info.point_cloud.points, info.point_cloud.colors,
                max_sh_degree=cfg.sh_degree, spatial_lr_scale=self.cameras_extent,
                capacity=capacity, device=self.device,
            )

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras

    def save(self, iteration: int, model: GaussianModel, exposures=None) -> None:
        """PLY snapshot of the alive slots + ``exposure.json``."""
        out_dir = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        save_model_ply(os.path.join(out_dir, "point_cloud.ply"), model)
        if exposures is not None:
            exp = {cam.image_name: exposures[cam.exposure_idx].cpu().numpy().tolist()
                   for cam in self.train_cameras}
            with open(os.path.join(self.model_path, "exposure.json"), "w") as f:
                json.dump(exp, f, indent=2)


def save_model_ply(path: str, model: GaussianModel) -> None:
    alive = model.alive.cpu().numpy()
    save_gaussian_ply(path, **{name: getattr(model, name).detach().cpu().numpy()[alive]
                               for name in PARAM_NAMES})
