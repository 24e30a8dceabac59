#!/usr/bin/env python3
"""Time variants of the port's CUDA sources side by side on one NVIDIA card.

    python3 kernel_variants.py

Each variant is the sources of `igg_torch/csrc` with one text edit or one
extra `nvcc` flag, built into a directory of its own under `_build`.  The
wrappers of `igg_torch.ops` are pointed at each variant's libraries in turn
and the kernels are timed with CUDA events at the main path's shapes; the
variants run in the order A B .. B A, so drift on the card shows.  The
variants are the design choices the sources record:

- `as_built`: the sources as they are;
- `ldg_loads`: the walk's loads through the read-only path (`__ldg`);
- `vec_8B`: 8-byte vectors per thread instead of 16-byte ones (the 3-D
  walk's kernels; the wave2d kernels keep theirs);
- `approx_div`: `-prec-div=false`.  Not bitwise equal to the plain
  versions, so never shipped: it measures what the IEEE divisions of the
  HM3D and wave2d kernels cost.

Prints one JSON line per variant (milliseconds per launch, each a list of
the two runs), then the card's name and power limit.  Needs
`torch.cuda.is_available()`; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

LDG_LOAD = """template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  if constexpr (sizeof(T) * VEC == 16) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    return *reinterpret_cast<const Vec<T, VEC>*>(&w);
  } else if constexpr (sizeof(T) * VEC == 8) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    return *reinterpret_cast<const Vec<T, VEC>*>(&w);
  } else {
    return Vec<T, VEC>{{__ldg(p)}};
  }
}"""
PLAIN_LOAD = """template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}"""


def ldg_loads(name, text):
    if name != "step_walk.cuh":
        return text
    if PLAIN_LOAD not in text or "  return *p;\n" not in text:
        raise RuntimeError("step_walk.cuh no longer has the plain loads")
    return text.replace(PLAIN_LOAD, LDG_LOAD).replace("  return *p;\n",
                                                      "  return __ldg(p);\n")


def vec_8b(name, text):
    return text.replace("constexpr int VEC = 16 / sizeof(typename P::T);",
                        "constexpr int VEC = 8 / sizeof(typename P::T);")


VARIANTS = {
    "as_built": (lambda name, text: text, []),
    "ldg_loads": (ldg_loads, []),
    "vec_8B": (vec_8b, []),
    "approx_div": (lambda name, text: text, ["-prec-div=false"]),
}
LIBS = ("diffusion_step", "diffusion_chunk", "hm3d_step", "hm3d_chunk",
        "wave2d_step", "wave2d_chunk")


def build(variant):
    """Build the variant's libraries; returns {library name: CDLL}."""
    from igg_torch.ops import _build

    edit, flags = VARIANTS[variant]
    out = os.path.join(_build.BUILD_DIR, f"variant_{variant}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in os.listdir(_build.CSRC):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, f)) as src:
                text = edit(f, src.read())
            with open(os.path.join(out, f), "w") as dst:
                dst.write(text)
    procs = {lib: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, *flags, "-o",
         os.path.join(out, f"{lib}.so"), os.path.join(out, f"{lib}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib in LIBS}
    libs = {}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}/{lib}:\n{log}")
        libs[lib] = ctypes.CDLL(os.path.join(out, f"{lib}.so"))
        fn_name, argtypes = _build.SIGNATURES[lib]
        fn = getattr(libs[lib], fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return libs


def event_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def cases(dev):
    """(name, setup) pairs; setup() returns a function that launches the
    kernel once (for a chunk, K launches) and the launches it makes."""
    import igg_torch as it
    from igg_torch.models import hm3d as h3
    from igg_torch.ops import chunk_engine as ce
    from igg_torch.ops import diffusion_pallas as dp
    from igg_torch.ops import diffusion_trapezoid as dtz
    from igg_torch.ops import hm3d_pallas as hp
    from igg_torch.ops import hm3d_trapezoid as htz
    from igg_torch.models import wave2d as w2
    from igg_torch.ops import wave2d_pallas as wp
    from igg_torch.ops import wave2d_trapezoid as wtz

    n, K = 256, 8
    sc = dp.scal(0.04, 0.04, 0.04)

    def grid(**kw):
        if it.grid_is_initialized():
            it.finalize_global_grid()
        it.init_global_grid(n, n, n, quiet=True, device=dev, **kw)
        return it.get_global_grid()

    one_block = dict(dimx=1, dimy=1, dimz=1, periodx=1, periody=1, periodz=1)

    def diffusion_step():
        g = grid(**one_block)
        T = torch.rand((n,) * 3, device=dev)
        A, out = 0.01 * torch.rand_like(T), torch.empty_like(T)
        return lambda: dp.launch_step(T, A, dp.step_modes(g), {}, g.dims, sc,
                                      out=out), 1

    def diffusion_chunk():
        g = grid(dimx=2, dimy=2, dimz=2)
        modes = ce.dim_modes(g)
        T = torch.rand(it.stacked_shape(g.nxyz), device=dev)
        Text, A_ext = ce.extend_fields([T, 0.01 * torch.rand_like(T)],
                                       ce.field_ols(g, [g.nxyz]) * 2, K, g,
                                       modes)
        return lambda: dtz.chunk_call(Text, A_ext, g.nxyz, K=K, modes=modes,
                                      grid=g, sc=sc), K

    def hm3d_step(state):
        def setup():
            g = grid(**one_block)
            p = h3.Params()
            if state == "random":
                Pe = -0.5 * torch.rand((n,) * 3, device=dev)
                phi = 0.1 + 0.1 * torch.rand_like(Pe)
            else:
                Pe, phi = h3.init_fields(p)
            out = (torch.empty_like(Pe), torch.empty_like(phi))
            return lambda: hp.launch_step(Pe, phi, hp.step_modes(g), ({}, {}),
                                          g.dims, p.step_kwargs(), out=out), 1
        return setup

    def hm3d_chunk():
        g = grid(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
        modes = ce.dim_modes(g)
        Pe = -0.5 * torch.rand(it.stacked_shape(g.nxyz), device=dev)
        exts = ce.extend_fields([Pe, 0.1 + 0.1 * torch.rand_like(Pe)],
                                ce.field_ols(g, [g.nxyz]) * 2, K, g, modes)
        kw = h3.Params().step_kwargs()
        return lambda: htz.chunk_call(exts, g.nxyz, K=K, modes=modes, grid=g,
                                      kw=kw), K

    def wave2d(blocks, chunk):
        """The wave2d step or K-step chunk on `blocks` x 1 blocks of
        4096^2, periodic, random fields."""
        def setup():
            if it.grid_is_initialized():
                it.finalize_global_grid()
            it.init_global_grid(4096, 4096, 1, quiet=True, device=dev,
                                dimx=blocks, dimy=1, dimz=1, periodx=1,
                                periody=1)
            g = it.get_global_grid()
            kw = w2.Params().step_kwargs()
            shapes = wp.field_shapes(g.nxyz[:2])
            S = [2 * torch.rand(it.stacked_shape(s), device=dev) - 1
                 for s in shapes]
            if not chunk:
                out = [torch.empty_like(A) for A in S]
                return lambda: wp.launch_step(*S, g.dims[:2], kw, out=out), 1
            modes = ce.dim_modes(g)[:2]
            ols = ce.field_ols(g, shapes)
            exts = ce.extend_fields(S, ols, 2 * K, g, modes)
            return lambda: wtz.chunk_call(exts, shapes, K=K, modes=modes,
                                          grid=g, kw=kw, ols=ols), K
        return setup

    return [("diffusion_step_256", diffusion_step),
            ("diffusion_chunk_2x2x2_256_open", diffusion_chunk),
            ("hm3d_step_256_random", hm3d_step("random")),
            ("hm3d_step_256_init_fields", hm3d_step("init_fields")),
            ("hm3d_chunk_2x2x2_256_periodic", hm3d_chunk),
            ("wave2d_step_4096", wave2d(1, False)),
            ("wave2d_step_8x1_4096", wave2d(8, False)),
            ("wave2d_chunk_8x1_4096_periodic", wave2d(8, True))]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from igg_torch.ops import (diffusion_pallas, diffusion_trapezoid,
                               hm3d_pallas, hm3d_trapezoid, wave2d_pallas,
                               wave2d_trapezoid)

    wrappers = (diffusion_pallas, diffusion_trapezoid, hm3d_pallas,
                hm3d_trapezoid, wave2d_pallas, wave2d_trapezoid)
    built = {v: build(v) for v in VARIANTS}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    times = {v: {} for v in VARIANTS}
    for name, setup in cases(torch.device("cuda")):
        run, launches = setup()
        for v in order:
            for m in wrappers:
                m.library = built[v].__getitem__
            times[v].setdefault(name, []).append(
                event_ms(run, max(2, 40 // launches)) / launches)
        del run
    for v in VARIANTS:
        print(json.dumps({"variant": v, "ms_per_launch": times[v]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
