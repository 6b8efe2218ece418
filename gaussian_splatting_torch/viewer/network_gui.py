"""Remote-viewer TCP bridge, wire-compatible with the SIBR Gaussian viewer.

Counterpart of ``gaussian_splatting_tpu/viewer/network_gui.py``, speaking the
reference protocol:

- a non-blocking TCP listener, one client at a time;
- client -> trainer: a 4-byte little-endian length, then UTF-8 JSON with
  ``resolution_x/y``, ``train``, ``fov_x/y``, ``z_near/z_far``,
  ``shs_python``, ``rot_scale_python``, ``keep_alive``,
  ``scaling_modifier``, ``view_matrix`` and ``view_projection_matrix``
  (16 floats each, row-major, in torch's row-vector convention with the
  client's sign flips);
- trainer -> client: the raw H x W x 3 uint8 RGB frame (when one was
  rendered), then a 4-byte length-prefixed ASCII "verify" string, the
  dataset's source path.

``_decode_camera`` negates view columns 1 and 2 and projection column 1 as
the reference's ``receive`` does, then transposes into the column-vector
convention of ``ops.camera_math.CameraParams``.
"""

from __future__ import annotations

import json
import socket
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.ops.camera_math import CameraParams


@dataclass
class ViewerRequest:
    """One decoded client message."""

    cam: Optional[CameraParams]
    do_training: bool = True
    shs_python: bool = False
    rot_scale_python: bool = False
    keep_alive: bool = False
    scaling_modifier: float = 1.0


def _decode_camera(message: dict, device=None) -> Optional[CameraParams]:
    """The message's camera on ``device``; None for a zero resolution."""
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    if width == 0 or height == 0:
        return None
    fovy = float(message["fov_y"])
    fovx = float(message["fov_x"])

    wvt = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    wvt[:, 1] = -wvt[:, 1]
    wvt[:, 2] = -wvt[:, 2]
    fullproj = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
    fullproj[:, 1] = -fullproj[:, 1]

    # torch row-vector convention -> column-vector convention
    viewmatrix = wvt.T
    projmatrix = fullproj.T
    campos = np.linalg.inv(viewmatrix)[:3, 3]
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return CameraParams(
        viewmatrix=put(viewmatrix),
        projmatrix=put(projmatrix),
        campos=put(campos),
        tan_fovx=float(np.tan(fovx * 0.5)),
        tan_fovy=float(np.tan(fovy * 0.5)),
        width=width,
        height=height,
    )


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("viewer client closed the connection")
        buf += part
    return buf


class ViewerServer:
    """Non-blocking listener and the length-prefixed JSON message loop.
    Cameras are decoded onto ``device`` (the card unless it says
    otherwise)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device=None):
        self.host = host
        self.port = port
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
            self.listener.settimeout(0)
        except OSError:
            self.listener.close()
            raise
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        """Accept a pending client, if there is one."""
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nViewer connected by {addr}")
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def receive(self) -> ViewerRequest:
        """Block for one message from the connected client."""
        if self.conn is None:
            raise ConnectionError("no viewer client is connected")
        length = int.from_bytes(_recv_exact(self.conn, 4), "little")
        message = json.loads(_recv_exact(self.conn, length).decode("utf-8"))
        cam = _decode_camera(message, self.device)
        if cam is None:
            return ViewerRequest(cam=None)
        return ViewerRequest(
            cam=cam,
            do_training=bool(message["train"]),
            shs_python=bool(message["shs_python"]),
            rot_scale_python=bool(message["rot_scale_python"]),
            keep_alive=bool(message["keep_alive"]),
            scaling_modifier=float(message["scaling_modifier"]),
        )

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        """Send a rendered frame (raw RGB bytes) and the verify string."""
        if self.conn is None:
            raise ConnectionError("no viewer client is connected")
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()


def image_to_bytes(image) -> bytes:
    """(3, H, W) float image in [0, 1] (array or tensor) -> raw H x W x 3
    uint8 bytes, clipped and truncated (0.5 becomes 127), as the reference
    trainer sends frames."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.clip(np.asarray(image), 0.0, 1.0)
    return np.ascontiguousarray((img * 255.0).astype(np.uint8).transpose(1, 2, 0)).tobytes()


def poll_viewer(server: ViewerServer, render_fn, source_path: str, iteration: int,
                max_iterations: int) -> None:
    """One training-loop poll: accept a waiting client, then serve frames
    until the client asks training to go on.  ``render_fn(cam,
    scaling_modifier)`` returns a (3, H, W) float image.  Any error is
    printed with its traceback and drops the client; training goes on."""
    if server.conn is None:
        server.try_connect()
    while server.conn is not None:
        try:
            req = server.receive()
            image_bytes = None
            if req.cam is not None:
                image_bytes = image_to_bytes(render_fn(req.cam, req.scaling_modifier))
            server.send(image_bytes, source_path)
            if req.do_training and (iteration < max_iterations or not req.keep_alive):
                break
        except Exception:
            traceback.print_exc()
            server.disconnect()
