"""Scene container for rendering a trained model.

Counterpart of ``gaussian_splatting_tpu/scene.py`` limited to loading a
trained iteration: dataset cameras + the ``point_cloud.ply`` snapshot.
Creating a model from the dataset's point cloud belongs to the training
slice.
"""

from __future__ import annotations

import os
from typing import List

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.config import ModelConfig
from gaussian_splatting_torch.data.cameras import Camera, load_camera
from gaussian_splatting_torch.data.dataset import SceneInfo, detect_and_load_scene
from gaussian_splatting_torch.models.gaussians import load_model_ply


class Scene:
    def __init__(
        self,
        cfg: ModelConfig,
        load_iteration: int = -1,
        device=None,
    ):
        if load_iteration is None:
            raise NotImplementedError("training a new model: a later slice")
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.device = resolve_device(device)
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
            eval_split=cfg.eval,
            white_background=cfg.white_background,
        )
        kw = dict(resolution=cfg.resolution, white_background=cfg.white_background,
                  device=self.device)
        print("Loading Training Cameras")
        self.train_cameras = [load_camera(ci, **kw) for ci in info.train_cameras]
        print("Loading Test Cameras")
        self.test_cameras = [load_camera(ci, **kw) for ci in info.test_cameras]

        self.gaussians = load_model_ply(
            os.path.join(
                self.model_path, "point_cloud", f"iteration_{self.loaded_iter}",
                "point_cloud.ply",
            ),
            max_sh_degree=cfg.sh_degree,
            device=self.device,
        )

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras
