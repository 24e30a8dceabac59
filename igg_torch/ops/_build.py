"""Build and load the port's CUDA kernels.

Each `igg_torch/csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, `igg_torch/_build/<name>-<hash>.so`
(the hash covers the sources and flags, so an edited kernel rebuilds), and
loaded with `ctypes`.  Nothing is built when a module is imported: the
first call that needs a library builds it; :func:`build_all` builds every
library at once, one `nvcc` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(_ROOT, "_build")

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC",
         # No fused multiply-add: the kernels then round exactly like their
         # plain PyTorch versions (separate multiply and add).
         "-fmad=false"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_D = ctypes.c_double
# C signature of each library's entry point: (name, argtypes).
SIGNATURES: Dict[str, tuple] = {
    "halo_write": ("igg_halo_write",
                   [_P, _I, ctypes.POINTER(_I), ctypes.POINTER(_P), _P]),
    "diffusion_step": ("igg_diffusion_step",
                       [_P, _P, _P, _I, ctypes.POINTER(_I), ctypes.POINTER(_P),
                        _D, _D, _D, _D, _P]),
    "diffusion_chunk": ("igg_diffusion_chunk_step",
                        [_P, _P, _P, _P, _I, ctypes.POINTER(_I),
                         _D, _D, _D, _D, _P]),
    "pack_planes": ("igg_pack_planes",
                    [_P, _I, ctypes.POINTER(_I), _I, ctypes.POINTER(_I),
                     ctypes.POINTER(_P), _P]),
    "hm3d_step": ("igg_hm3d_step",
                  [_P, _P, _P, _P, _I, ctypes.POINTER(_I), ctypes.POINTER(_P),
                   ctypes.POINTER(_D), _I, _P]),
    "hm3d_chunk": ("igg_hm3d_chunk_step",
                   [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
                    _I, ctypes.POINTER(_I), ctypes.POINTER(_D), _I, _P]),
    "wave2d_step": ("igg_wave2d_step",
                    [ctypes.POINTER(_P), ctypes.POINTER(_P), _I,
                     ctypes.POINTER(_I), ctypes.POINTER(_D), _P]),
    "wave2d_chunk": ("igg_wave2d_chunk_step",
                     [ctypes.POINTER(_P), ctypes.POINTER(_P), _I,
                      ctypes.POINTER(_I), ctypes.POINTER(_D), _P]),
    "stokes_step": ("igg_stokes_step",
                    [ctypes.POINTER(_P), _P, ctypes.POINTER(_P), _I,
                     ctypes.POINTER(_I), ctypes.POINTER(_D), _P]),
    "stokes_chunk": ("igg_stokes_chunk_step",
                     [ctypes.POINTER(_P), ctypes.POINTER(_P), _P,
                      ctypes.POINTER(_P), _I, ctypes.POINTER(_I),
                      ctypes.POINTER(_D), _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: not on PATH, and no {path}")
    return path


def _sources(name: str) -> List[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, h)
                                                  for h in headers]


def lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc for `name` into a temporary file; returns
    (process, tmp, final) or None when the library is already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one build; returns nvcc's report (registers, spills)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's report per
    library ('' for one already built)."""
    with _lock:
        jobs = {name: _start(name) for name in SIGNATURES}
        return {name: _finish(name, job) for name, job in jobs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            _finish(name, _start(name))
            lib = ctypes.CDLL(lib_path(name))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]
