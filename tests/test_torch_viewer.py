"""The port's viewer bridge against the JAX package's: camera decoding and
frame bytes bit for bit, JAX's loopback round trip run against the port, a
small model's frame against JAX's ``render_custom_cam`` (its dense render),
and the training loop serving a client, with the CLI's viewer flags."""

import json
import os
import socket
import sys
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussian_splatting_torch.data.ply import save_point_cloud_ply
from gaussian_splatting_torch.interop import model_from_jax_params
from gaussian_splatting_torch.ops import rasterize
from gaussian_splatting_torch.ops.camera_math import look_at, make_camera
from gaussian_splatting_torch.train import cli, loop
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset
from gaussian_splatting_torch.utils.testing import ViewerClient, random_arrays, viewer_message
from gaussian_splatting_torch.viewer import network_gui as gui
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRasterizeConfig
from gaussian_splatting_tpu.models.gaussians import GaussianAux, GaussianModel, GaussianParams
from gaussian_splatting_tpu.train.loop import render_custom_cam as jax_render_custom_cam
from gaussian_splatting_tpu.viewer import network_gui as jgui

W, H = 40, 30  # not tile-aligned


def _seeded_message(rng, width=W, height=H):
    return {
        "resolution_x": width, "resolution_y": height, "train": bool(rng.integers(2)),
        "fov_x": float(rng.uniform(0.5, 1.5)), "fov_y": float(rng.uniform(0.5, 1.5)),
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        # a well-conditioned view (rotation-like plus translation) and any projection
        "view_matrix": (np.eye(4) + rng.normal(0, 0.2, (4, 4))).ravel().tolist(),
        "view_projection_matrix": rng.normal(0, 1, 16).tolist(),
    }


def test_decode_camera_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(20):
        msg = _seeded_message(rng)
        ours, ref = gui._decode_camera(msg, "cpu"), jgui._decode_camera(msg)
        for field in ("viewmatrix", "projmatrix", "campos"):
            a, b = getattr(ours, field).numpy(), getattr(ref, field)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        for field in ("tan_fovx", "tan_fovy", "width", "height"):
            assert getattr(ours, field) == getattr(ref, field)
    assert gui._decode_camera(_seeded_message(rng, 0, H), "cpu") is None


def test_image_to_bytes_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.2, 1.2, (3, H, W)).astype(np.float32)
    img[:, 0, :4] = [0.5, 1.0, 0.0, 254.5 / 255]
    ref = jgui.image_to_bytes(img)
    assert gui.image_to_bytes(img) == ref
    assert gui.image_to_bytes(torch.from_numpy(img)) == ref
    assert np.frombuffer(ref, np.uint8)[0] == 127  # truncated, not rounded


def _send_msg(sock, payload: dict):
    data = json.dumps(payload).encode("utf-8")
    sock.sendall(len(data).to_bytes(4, "little"))
    sock.sendall(data)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        assert part, "server closed"
        buf += part
    return buf


def test_viewer_roundtrip_loopback():
    """JAX's loopback test (``tests/test_aux_subsystems.py``) against the
    port: a client speaks the SIBR protocol; the server renders and replies."""
    server = gui.ViewerServer("127.0.0.1", 0, device="cpu")
    port = server.listener.getsockname()[1]
    w, h = 8, 6
    msg = {
        "resolution_x": w, "resolution_y": h, "train": True, "fov_y": 0.8, "fov_x": 1.0,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": np.eye(4, dtype=np.float32).flatten().tolist(),
        "view_projection_matrix": np.eye(4, dtype=np.float32).flatten().tolist(),
    }
    received = {}

    def client():
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        _send_msg(sock, msg)
        received["image"] = _recv_exact(sock, w * h * 3)
        vlen = int.from_bytes(_recv_exact(sock, 4), "little")
        received["verify"] = _recv_exact(sock, vlen).decode("ascii")
        sock.close()

    t = threading.Thread(target=client)
    t.start()
    rendered = {}

    def render_fn(cam, scaling_modifier):
        rendered["cam"] = cam
        rendered["sm"] = scaling_modifier
        return np.full((3, cam.height, cam.width), 0.5, np.float32)

    for _ in range(100):
        gui.poll_viewer(server, render_fn, "/data/scene", 1, 100)
        if "cam" in rendered:
            break
        time.sleep(0.05)
    t.join(timeout=5)
    server.close()
    assert not t.is_alive()

    assert rendered["cam"].width == w and rendered["cam"].height == h
    assert rendered["sm"] == 1.0
    img = np.frombuffer(received["image"], np.uint8).reshape(h, w, 3)
    assert (img == 127).all()  # 0.5 * 255 = 127.5 -> 127
    assert received["verify"] == "/data/scene"
    expected_view = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(rendered["cam"].viewmatrix.numpy(), expected_view)


def _models(sh_degree=1):
    """One seeded model in both packages' forms."""
    means, scales, quats, opac, sh = random_arrays(300, sh_degree=sh_degree, seed=4,
                                                   scale_range=(0.02, 0.1))
    params = dict(means3d=means, features_dc=sh[:, :1], features_rest=sh[:, 1:],
                  opacities=np.log(opac / (1.0 - opac)), scales=np.log(scales), quats=quats)
    alive = np.ones(len(means), bool)
    jmodel = GaussianModel(
        params=GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        aux=GaussianAux(alive=jnp.asarray(alive), max_radii2d=jnp.zeros(len(means)),
                        xyz_grad_accum=jnp.zeros(len(means)), denom=jnp.zeros(len(means))),
        spatial_lr_scale=jnp.float32(1.0), sh_degree=jnp.int32(sh_degree),
        max_sh_degree=sh_degree)
    tmodel = model_from_jax_params(params, alive, max_sh_degree=sh_degree, sh_degree=sh_degree,
                                   device="cpu")
    return SimpleNamespace(model=tmodel), SimpleNamespace(model=jmodel)


def test_viewer_frame_matches_jax_render_custom_cam():
    ours, ref = _models()
    R, t = look_at([0.6, -0.4, -3.5], [0.0, 0.0, 0.0])
    cam = make_camera(R, t, 0.9, 0.7, W, H, device="cpu")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    server = gui.ViewerServer("127.0.0.1", 0, device="cpu")
    client = ViewerClient("127.0.0.1", server.listener.getsockname()[1], timeout=10)
    frames = {}

    def talk():
        for sm in (1.0, 0.6):
            frames[sm] = client.request(viewer_message(cam, train=sm != 1.0,
                                                       scaling_modifier=sm))
        client.close()

    t = threading.Thread(target=talk)
    t.start()
    try:
        gui.poll_viewer(server, lambda c, sm: loop.render_custom_cam(ours, c, bg,
                                                                     scale_modifier=sm),
                        "/data/scene", 1, 10)
    finally:
        t.join(timeout=10)
        server.close()
    assert not t.is_alive()
    for sm in (1.0, 0.6):
        frame, verify = frames[sm]
        assert verify == "/data/scene"
        jcam = jgui._decode_camera(viewer_message(cam, train=False, scaling_modifier=sm))
        expected = jgui.image_to_bytes(np.asarray(jax_render_custom_cam(
            ref, jcam, bg, scale_modifier=sm, raster=JaxRasterizeConfig(impl="dense"))))
        a = np.frombuffer(frame, np.uint8).astype(int)
        b = np.frombuffer(expected, np.uint8).astype(int)
        assert a.size == W * H * 3 and b.std() > 5
        assert np.abs(a - b).max() <= 1, sm


def test_render_custom_cam_returns_the_frame_past_slack_512(monkeypatch):
    ours, _ = _models()
    R, t = look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0])
    cam = make_camera(R, t, 0.9, 0.7, W, H, device="cpu")
    real = loop.RasterizeConfig
    slacks = []

    def overflowing(*args, cfg, **kw):
        slacks.append(cfg.instance_slack)
        image = torch.full((3, H, W), 0.25)
        return SimpleNamespace(image=image, overflow=torch.tensor(True))

    monkeypatch.setattr(rasterize, "render_stored", overflowing)
    image = loop.render_custom_cam(ours, cam, np.zeros(3), raster=real(instance_slack=100.0))
    assert slacks == [100.0, 200.0, 400.0, 800.0]
    assert torch.equal(image, torch.full((3, H, W), 0.25))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("viewer_scene"))
    generate_blender_dataset(out, num_train=3, num_test=1, width=32, height=24,
                             num_gaussians=150, device="cpu")
    rng = np.random.default_rng(5)
    save_point_cloud_ply(os.path.join(out, "points3d.ply"),
                         rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32),
                         rng.integers(0, 256, (300, 3), dtype=np.uint8))
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_serves_a_viewer_client(dataset, tmp_path):
    """A client connects during iteration 1, asks for a frame without
    training and then one with; training runs all its iterations."""
    port = _free_port()
    connected = threading.Event()
    frames = []
    R, t = look_at([0.0, 0.5, -4.0], [0.0, 0.0, 0.0])
    cam = make_camera(R, t, 0.9, 0.7, 32, 24, device="cpu")

    def client():
        c = ViewerClient("127.0.0.1", port, timeout=10)
        connected.set()
        for train in (False, True):
            frames.append(c.request(viewer_message(cam, train=train)))
        c.close()

    def on_iteration(iteration, state, metrics):
        if iteration == 1:
            connected.wait(timeout=10)

    t = threading.Thread(target=client)
    t.start()
    try:
        state = loop.train(ModelConfig(source_path=dataset, model_path=str(tmp_path / "m"),
                                       eval=True),
                           OptimizationConfig(iterations=4), PipelineConfig(),
                           test_iterations=(), save_iterations=(), capacity=512,
                           on_iteration=on_iteration, viewer_ip="127.0.0.1", viewer_port=port,
                           device="cpu")
    finally:
        t.join(timeout=10)
    assert not t.is_alive()
    assert int(state.step) == 4
    assert len(frames) == 2
    for frame, verify in frames:
        assert verify == dataset
        assert len(frame) == cam.width * cam.height * 3
    assert frames[0][0] == frames[1][0]  # no step between the two frames
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))  # the loop closed its listener


def test_train_runs_on_when_the_port_is_taken(dataset, tmp_path, capsys):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        state = loop.train(ModelConfig(source_path=dataset, model_path=str(tmp_path / "m"),
                                       eval=True),
                           OptimizationConfig(iterations=1), PipelineConfig(),
                           test_iterations=(), save_iterations=(), capacity=512,
                           viewer_ip="127.0.0.1", viewer_port=busy.getsockname()[1],
                           device="cpu")
    assert int(state.step) == 1
    assert "Viewer server unavailable" in capsys.readouterr().out


@pytest.mark.parametrize("flags, ip, port", [
    ([], "127.0.0.1", 6009),
    (["--ip", "0.0.0.0", "--port", "7001"], "0.0.0.0", 7001),
    (["--disable_viewer", "--port", "7001"], "", 7001),
])
def test_cli_viewer_flags_reach_train(flags, ip, port, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = {}
    monkeypatch.setattr(loop, "train", lambda *a, **kw: seen.update(kw))
    cli.main(["-s", "scene", "-m", str(tmp_path / "out"), "--device", "cpu"] + flags)
    assert (seen["viewer_ip"], seen["viewer_port"]) == (ip, port)


def test_disable_viewer_opens_no_listener(dataset, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    opened = []
    monkeypatch.setattr(gui, "ViewerServer", lambda *a, **kw: opened.append(a))
    state = cli.main(["-s", dataset, "-m", str(tmp_path / "out"), "--iterations", "1",
                      "--capacity", "512", "--save_iterations", "1", "--test_iterations", "1",
                      "--disable_viewer", "--quiet", "--device", "cpu"])
    assert int(state.step) == 1 and opened == []


def test_viewer_server_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gui.ViewerServer("127.0.0.1", 0)
