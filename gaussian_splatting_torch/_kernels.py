"""Build and bind the hand-written CUDA kernels in ``csrc/``, and the one
host function there (``image_resize.cpp``).

Each ``csrc/<name>.cu`` exports a plain C interface (no PyTorch headers), is
compiled by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at first
use, and is called through ``ctypes``.  Every C entry point takes device
pointers and the current CUDA stream and returns ``cudaGetLastError()`` after
its launch; ``launch`` raises on a nonzero code.  Library file names carry a
hash of the source and flags, so an edited source is rebuilt.

The CUDA wrappers in ``ops/`` only reach this module for CUDA tensors.
``host_library`` builds a C++ source with ``g++`` the same way, for the
image loader on either device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

# No --use_fast_math, and no multiply-add contraction: the kernels then round
# exactly like their plain PyTorch twins, which run one operation per pass.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

# The kernels each path launches: the render path K8 and K1-K3, the
# training step (and the training loop around it) K1-K6; K7 lies on no path.
RENDER_KERNELS = ("project", "expand", "blend_forward", "untile")
TRAIN_KERNELS = ("expand", "blend_forward", "untile", "retile", "blend_backward",
                 "segment_reduce")
KERNELS = ("project",) + TRAIN_KERNELS + ("segscan",)

# Launch counts per kernel.  ``launch`` adds one per successful launch.
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _source(name: str, ext: str = ".cu") -> str:
    return os.path.join(CSRC_DIR, f"{name}{ext}")


def _lib_path(name: str, ext: str = ".cu", flags: Sequence[str] = NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    with open(_source(name, ext), "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS, force: bool = False) -> Dict[str, str]:
    """Compile every named kernel that has no current library (every one
    with ``force``), one ``nvcc`` per source, all started together.  Returns
    each build's compiler output (the ``-Xptxas -v`` register /
    shared-memory / spill report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out) and not force:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            lib.gs_error_string.restype = ctypes.c_char_p
            lib.gs_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


# The JAX package's native host library's flags (gaussian_splatting_tpu/
# native/__init__.py::_build), so that a function copied from it compiles to
# the same arithmetic, fused multiply-adds included.
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def host_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cpp`` built by ``g++`` with ``HOST_FLAGS`` into the
    build directory at first use, and loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            # -march=native builds for this host: a copy of the build
            # directory on another machine must not load it
            out = _lib_path(name, ".cpp", HOST_FLAGS + (platform.node(),))
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", *HOST_FLAGS, _source(name, ".cpp"), "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
    return lib


def launch(name: str, fn_name: str, argtypes: Sequence, *args) -> None:
    """Call ``fn_name`` of kernel library ``name``; raise if the launch failed.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the
    stream (a bare Python int would be passed as a 32-bit int)."""
    fn = _fns.get((name, fn_name))
    if fn is None:
        fn = getattr(library(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, fn_name)] = fn
    err = fn(*args)
    if err != 0:
        msg = library(name).gs_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({err}): {msg}")
    launches[name] += 1


def current_stream(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, without
    building a ``torch.cuda.Stream`` object."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def check_cuda(name: str, *tensors, contiguous: bool = True) -> None:
    """Wrappers' argument check: tensors on one CUDA device, contiguous
    unless the wrapper checks the strides itself."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
