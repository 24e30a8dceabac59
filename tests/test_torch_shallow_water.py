"""The port's shallow-water family (igg_torch.models.shallow_water) held
against igg's on the CPU.

igg runs as tests/test_stencil.py runs it (its generated tiers in
interpret mode on the 8-device CPU mesh, its XLA composition); the port
runs with `device="cpu"`, where the generated kernels' plain versions
serve.  Tolerances: igg's own (decomposition invariance float64 absolute
1e-12, mass conserved within 1e-6 relative over 30 steps); `init_fields`
`hu`/`hv` bitwise and `h` within relative 1e-6 (float32 `exp` may round
differently); the port's routes against igg's float32 relative 2e-5 of
each field's largest magnitude (igg's compiled XLA divides by constants
through their reciprocals); the port's routes against each other, 0,
except the chunk on open dims of several blocks, where igg's own bound for
open spec chunks, 2e-5 of each field's scale, holds.
"""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from helpers import assert_halo_agreement
from igg.models import shallow_water as isw
from igg_torch import convert
from igg_torch.models import shallow_water as tsw
from igg_torch.stencil import cuda
from igg_torch.stencil import lower

NAMES = ("h", "hu", "hv")


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, dims, periods):
    kw = dict(dimx=dims[0], dimy=dims[1], dimz=1, periodx=periods[0],
              periody=periods[1], quiet=True)
    igg.init_global_grid(local[0], local[1], 1, **kw)
    it.init_global_grid(local[0], local[1], 1, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)


def to_port(fields):
    st = convert.to_torch({n: np.asarray(a) for n, a in zip(NAMES, fields)})
    return tuple(st[n] for n in NAMES)


def kernel_route(p, S, n, **kw):
    """`n` steps on the generated kernels' route (plain versions here)."""
    gen = cuda.kernels_for(tsw.spec(p), p.coeffs())
    return lower.fused_spec_steps(gen, S, n_inner=n, **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims,periods", [((4, 2), (1, 1)), ((1, 1), (1, 1)),
                                          ((4, 2), (0, 0))],
                         ids=["4x2_periodic", "1x1_periodic", "4x2_open"])
def test_init_fields_matches_igg(dims, periods, dtype):
    init_both((8, 6), dims, periods)
    ref = [np.asarray(a) for a in isw.init_fields(isw.Params(), dtype=dtype)]
    tp = convert.convert_params(isw.Params(), tsw.Params)
    got = [a.numpy() for a in tsw.init_fields(tp, dtype=getattr(
        torch, np.dtype(dtype).name))]
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_decomposition_invariance():
    """igg's test: 20 float64 steps on (4,2) blocks of 6x6 and on one block
    of 18x10 (the same global grid) agree within 1e-12."""
    def run(nx, ny, **kw):
        it.init_global_grid(nx, ny, 1, periodx=1, periody=1, quiet=True,
                            device="cpu", **kw)
        p = tsw.Params()
        state = tsw.init_fields(p, dtype=torch.float64)
        step = tsw.make_step(p)
        for _ in range(20):
            state = step(*state)
        out = tuple(it.gather_interior(a) for a in state)
        it.finalize_global_grid()
        return out

    multi = run(6, 6, nprocs=8)
    single = run(18, 10, dimx=1, dimy=1, dimz=1)
    for m, s, name in zip(multi, single, NAMES):
        assert m.shape == s.shape, name
        np.testing.assert_allclose(m, s, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_mass_conserved(route):
    """Periodic continuity: the float64 sum of h over the owned cells stays
    within 1e-6 relative over 30 steps."""
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu", nprocs=8)
    p = tsw.Params()
    state = tsw.init_fields(p)
    m0 = tsw.mass(state[0])
    if route == "plain":
        state = tsw.make_step(p, n_inner=30)(*state)
    else:
        state = kernel_route(p, state, 30)
    assert abs(tsw.mass(state[0]) - m0) / abs(m0) < 1e-6
    assert all(bool(torch.isfinite(a).all()) for a in state)


def test_friction_damps():
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu", nprocs=8)

    def energy(params, nt=40):
        state = tsw.init_fields(params, dtype=torch.float64)
        state = tsw.make_step(params, n_inner=nt)(*state)
        return sum(float((a ** 2).sum()) for a in state)

    assert energy(tsw.Params(cf=0.5)) < energy(tsw.Params())


@pytest.mark.parametrize("route", ["plain", "per_step", "chunk"])
def test_halo_agreement_staggered(route):
    """After steps of every route, each staggered field's overlap cells
    equal the owning neighbour's interior (igg's helper, on the same
    grid)."""
    init_both((8, 8), (4, 2), (1, 1))
    p = tsw.Params()
    state = tsw.init_fields(p)
    if route == "plain":
        state = tsw.make_step(p, n_inner=3)(*state)
    else:
        state = kernel_route(p, state, 5, K=2,
                             chunk=(route == "chunk"))
    for a, ls in zip(state, ((8, 8), (9, 8), (8, 9))):
        assert_halo_agreement(a.numpy(), ls)


@pytest.mark.parametrize("cf", [0.0, 0.1])
@pytest.mark.parametrize("dims,periods", [((4, 2), (1, 1)), ((4, 2), (1, 0)),
                                          ((1, 1), (1, 1))],
                         ids=["4x2_periodic", "4x2_config3", "1x1_periodic"])
def test_make_step_matches_igg(dims, periods, cf):
    """The family end to end: igg's `make_step` (its generated tiers in
    interpret mode) against the port's, from igg's `init_fields`, on the
    plain path and on the kernels' routes (per step, and the chunk where
    it admits: K = 2)."""
    init_both((8, 8), dims, periods)
    ip = isw.Params(cf=cf)
    state = isw.init_fields(ip)
    n = 7
    ref = isw.make_step(ip, donate=False, n_inner=n, use_pallas=True,
                        pallas_interpret=True)(*state)
    S = to_port(state)
    tp = convert.convert_params(ip, tsw.Params)
    plain = tsw.make_step(tp, n_inner=n, use_kernels=False)(*S)
    per_step = kernel_route(tp, S, n, chunk=False)
    chunk = kernel_route(tp, S, n, K=2)
    for got in (plain, per_step, chunk):
        for name, a, b in zip(NAMES, got, ref):
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            err = np.abs(a - b).max()
            assert err <= 2e-5 * (np.abs(b).max() + 1e-30), (name, err)
    for a, b in zip(per_step, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dims,periods,exact", [
    ((4, 2), (1, 1), True), ((8, 1), (1, 0), True), ((1, 1), (0, 0), True),
    ((4, 2), (1, 0), False), ((4, 2), (0, 0), False)],
    ids=["4x2_periodic", "8x1_config3", "1x1_open", "4x2_config3",
         "4x2_open"])
def test_chunk_route_against_per_step_route(dims, periods, exact,
                                            monkeypatch):
    """From an overlap-consistent state the chunk route (a warm-up step,
    the K-step chunks with the per-dim freezes on open dims, the remainder)
    runs the chunks it should and equals the per-step route bitwise on
    periodic dims and on open dims of one block ("frozen": the boundary
    planes are outside the updates' regions).  On an open dim of several
    blocks ("oext") the boundary row sits inside the extended window, so
    `h` reads a face the core computed from the shoulder before the freeze
    restores it: igg's window realizations do the same, and igg holds its
    open spec chunks to 2e-5 of each field's scale
    (tests/test_stencil.py:286-293), as here."""
    it.init_global_grid(16, 16, 1, dimx=dims[0], dimy=dims[1], dimz=1,
                        periodx=periods[0], periody=periods[1], quiet=True,
                        device="cpu")
    p = tsw.Params(cf=0.1)
    S = tsw.make_step(p, n_inner=2, use_kernels=False)(
        *it.update_halo(*tsw.init_fields(p)))
    done = []
    real = lower.spec_chunk_steps

    def spy(*a, **kw):
        out = real(*a, **kw)
        done.append(out[-1])
        return out

    monkeypatch.setattr(lower, "spec_chunk_steps", spy)
    chunk = kernel_route(p, S, 11, K=4)
    assert done == [8]
    per_step = kernel_route(p, S, 11, chunk=False)
    for a, b in zip(chunk, per_step):
        if exact:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


def test_auto_on_cpu_takes_plain_path():
    it.init_global_grid(8, 8, 1, periodx=1, periody=1, quiet=True,
                        device="cpu")
    p = tsw.Params()
    S = tsw.init_fields(p)
    before = (lower.step_kernel.launches, lower.chunk_call.launches)
    auto = tsw.make_step(p, n_inner=4)(*S)
    plain = tsw.make_step(p, n_inner=4, use_kernels=False)(*S)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (lower.step_kernel.launches, lower.chunk_call.launches) == before
    with pytest.raises(it.GridError, match="needs CUDA tensors"):
        tsw.make_step(p, use_kernels=True)(*S)
    (h, hu, hv), sec = tsw.run(4, p, use_kernels=False)
    assert sec > 0 and bool(torch.isfinite(h).all())
