"""Build and load the port's CUDA kernels.

Each `igg_torch/csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, `igg_torch/_build/<name>-<hash>.so`
(the hash covers the sources and flags, so an edited kernel rebuilds), and
loaded with `ctypes`.  A source generated from a stencil spec
(`igg_torch/stencil/cuda.py`, one per spec: its step, chunk step and, at
rank 3, band step) goes the same way through :func:`generated_library`:
its text is written to `igg_torch/_build/gen/<tag>-<hash>.cu`, where the
hash covers the text, every `csrc/*.cuh` header and the flags (two specs
of the same text share one build; an edited walk rebuilds every generated
library).  Nothing is
built when a module is imported: the first call that needs a library
builds it; :func:`build_all` builds every library at once (and any
generated sources it is given), one `nvcc` process per source, all started
together.
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
    "diffusion_band": ("igg_diffusion_band_step",
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
    "hm3d_band": ("igg_hm3d_band_step",
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
    "stokes_band": ("igg_stokes_band_step",
                    [ctypes.POINTER(_P), ctypes.POINTER(_P), _P,
                     ctypes.POINTER(_P), _I, ctypes.POINTER(_I),
                     ctypes.POINTER(_D), _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_generated: Dict[str, ctypes.CDLL] = {}   # generated source -> library


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: not on PATH, and no {path}")
    return path


def _headers() -> List[str]:
    return [os.path.join(CSRC, h)
            for h in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))]


def _key(texts) -> str:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for text in texts:
        h.update(text)
    return h.hexdigest()[:12]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def lib_path(name: str) -> str:
    srcs = [os.path.join(CSRC, f"{name}.cu")] + _headers()
    return os.path.join(BUILD_DIR, f"{name}-{_key(map(_read, srcs))}.so")


def generated_path(source: str, tag: str) -> str:
    """Where the library of a generated source goes (module docstring)."""
    key = _key([source.encode()] + [_read(h) for h in _headers()])
    return os.path.join(BUILD_DIR, "gen", f"{tag}-{key}.so")


def _start_nvcc(src: str, out: str):
    """Start one nvcc of `src` into a temporary file beside `out`; returns
    (process, tmp, out) or None when `out` is already built."""
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [nvcc(), *FLAGS, "-Xptxas", "-v", f"-I{CSRC}", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _start(name: str):
    return _start_nvcc(os.path.join(CSRC, f"{name}.cu"), lib_path(name))


def _start_generated(source: str, tag: str):
    out = generated_path(source, tag)
    if os.path.exists(out):
        return None
    src = out[:-len(".so")] + ".cu"
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(src, "w") as f:
        f.write(source)
    return _start_nvcc(src, out)


def _finish(name: str, job) -> str:
    """Wait for one build; returns nvcc's report (registers, spills)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(generated=()) -> Dict[str, str]:
    """Build every kernel library, and the generated sources `generated`
    (pairs of source text and tag), in parallel; returns nvcc's report per
    library ('' for one already built), generated ones under their tag."""
    with _lock:
        jobs = {name: _start(name) for name in SIGNATURES}
        for source, tag in generated:
            jobs[tag] = _start_generated(source, tag)
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


def generated_library(source: str, tag: str) -> ctypes.CDLL:
    """The loaded library of a generated source (its entry points
    `igg_spec_step` and, at rank 3, `igg_spec_band_step` typed), built
    first if needed; a failed build raises with nvcc's log."""
    from ..stencil.cuda import ARGTYPES, BAND_ENTRY, ENTRY

    # Keyed by the text itself: hashing it and reading the headers on every
    # launch would cost more host time than the launch.
    lib = _generated.get(source)
    if lib is not None:
        return lib
    with _lock:
        if source not in _generated:
            _finish(tag, _start_generated(source, tag))
            lib = ctypes.CDLL(generated_path(source, tag))
            for name in (ENTRY, BAND_ENTRY):
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = ARGTYPES
                    fn.restype = ctypes.c_int
            _generated[source] = lib
        return _generated[source]
