"""The port's grid core (igg_torch) held against igg on the CPU: topology,
init/finalize, coordinate tools, gather, `sharded`, and the port's
import isolation.  Inputs are made with numpy; the port runs with
`device="cpu"` and `nprocs` set to the 8 virtual devices igg sees."""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.topology import dims_create as igg_dims_create
from igg_torch import shared as tshared
from igg_torch.topology import dims_create

from helpers import encoded_field

PERIODIC = dict(periodx=1, periody=1, periodz=1)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def both_init(nx, ny, nz, **kw):
    """Initialize igg's grid and the port's with the same arguments."""
    igg.init_global_grid(nx, ny, nz, quiet=True, **kw)
    g = igg.get_global_grid()
    it.init_global_grid(nx, ny, nz, quiet=True, device="cpu", nprocs=g.nprocs,
                        **kw)
    return g, it.get_global_grid()


def test_import_isolation():
    """igg_torch imports neither jax nor anything of igg."""
    code = ("import sys, igg_torch, igg_torch.models.diffusion3d, "
            "igg_torch.convert, igg_torch.ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'igg' or m.startswith('igg.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("nprocs,dims,local", [
    (8, (0, 0, 0), None), (12, (0, 0, 0), None), (16, (0, 0, 0), None),
    (6, (0, 0, 1), None), (8, (2, 0, 0), None), (8, (8, 1, 1), None),
    (7, (0, 1, 1), None), (8, (0, 0, 0), (4, 16, 64)), (12, (0, 0, 1), (32, 8, 8)),
])
def test_dims_create_matches_igg(nprocs, dims, local):
    assert dims_create(nprocs, dims, local_shape=local) == igg_dims_create(
        nprocs, dims, local_shape=local)


def test_dims_create_rejects_like_igg():
    with pytest.raises(it.GridError):
        dims_create(8, (3, 0, 0))
    with pytest.raises(igg.GridError):
        igg_dims_create(8, (3, 0, 0))


@pytest.mark.parametrize("args,kw,match", [
    ((1, 4, 4), {}, "nx can never be 1"),
    ((4, 1, 4), {}, "ny cannot be 1"),
    ((4, 4, 1), dict(dimz=2), "Incoherent arguments"),
    ((4, 4, 2), dict(periodz=1), "Incoherent arguments"),
    ((4, 4, 4), dict(disp=0), "disp must be a positive integer"),
])
def test_init_validation_messages_match_igg(args, kw, match):
    with pytest.raises(igg.GridError, match=match) as e_ref:
        igg.init_global_grid(*args, quiet=True, **kw)
    with pytest.raises(it.GridError, match=match) as e_port:
        it.init_global_grid(*args, quiet=True, device="cpu", nprocs=8, **kw)
    assert str(e_port.value) == str(e_ref.value)


def test_init_twice_and_uninitialized_guard():
    with pytest.raises(it.GridError, match="init_global_grid"):
        it.nx_g()
    with pytest.raises(it.GridError, match="init_global_grid"):
        it.tic()
    it.init_global_grid(4, 4, 4, quiet=True, device="cpu")
    with pytest.raises(it.GridError, match="already been initialized"):
        it.init_global_grid(4, 4, 4, quiet=True, device="cpu")
    it.finalize_global_grid()
    assert not it.grid_is_initialized()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot run")
    with pytest.raises(it.GridError, match="cuda"):
        it.init_global_grid(4, 4, 4, quiet=True)
    assert not it.grid_is_initialized()


@pytest.mark.parametrize("n,kw", [
    ((4, 4, 4), {}),
    ((5, 6, 7), dict(dimx=2, dimy=2, dimz=2, periodx=1)),
    ((8, 8, 8), dict(overlapx=3, overlapy=4)),
    ((8, 8, 8), PERIODIC),
    ((8, 8, 1), {}),
    ((6, 6, 6), dict(dimx=1, dimy=1, dimz=1, periodz=1)),
])
def test_grid_state_matches_igg(n, kw):
    me, dims, nprocs, coords, dev = it.init_global_grid(
        *n, quiet=True, device="cpu", nprocs=8 if "dimx" not in kw else None,
        **kw)
    t = it.get_global_grid()
    igg.init_global_grid(*n, quiet=True, **kw)
    g = igg.get_global_grid()
    assert (me, dims, nprocs, coords) == (0, g.dims, g.nprocs, (0, 0, 0))
    assert dev == torch.device("cpu")
    for f in ("nxyz_g", "nxyz", "dims", "overlaps", "nprocs", "periods", "disp"):
        assert getattr(t, f) == getattr(g, f), f
    assert (it.nx_g(), it.ny_g(), it.nz_g()) == (igg.nx_g(), igg.ny_g(), igg.nz_g())
    for r in range(t.nprocs):
        c = t.cart_coords(r)
        assert c == g.cart_coords(r) and t.cart_rank(c) == r
        for d in range(3):
            assert t.neighbors_of(c, d) == g.neighbors_of(c, d)


def _seq(fn, n, d, A, coords=None):
    return [fn(i, d, A, coords) for i in range(n)]


@pytest.mark.parametrize("overlap", [False, True])
def test_xyz_g_tables_match_igg(overlap):
    """The golden tables of tests/test_tools.py, through both packages."""
    kw = dict(dimx=1, dimy=1, dimz=1, periodz=1)
    if overlap:
        n, kw = (5, 5, 8), dict(kw, overlapx=3, overlapz=3)
        shapes = [(5, 5, 8), (5, 5, 9), (5, 5, 10), (3, 4, 6)]
    else:
        n = (5, 5, 5)
        shapes = [(5, 5, 5), (6, 5, 5), (5, 5, 6), (5, 5, 7), (3, 4, 3)]
    both_init(*n, **kw)
    dx = 8 / (it.nx_g() - 1)
    dy = 8 / (it.ny_g() - 1)
    dz = 8 / (it.nz_g() - 1)
    for shp in shapes:
        A = np.zeros(shp)
        assert (it.nx_g(A), it.ny_g(A), it.nz_g(A)) == (
            igg.nx_g(A), igg.ny_g(A), igg.nz_g(A))
        for tf, gf, d, k in ((it.x_g, igg.x_g, dx, 0), (it.y_g, igg.y_g, dy, 1),
                             (it.z_g, igg.z_g, dz, 2)):
            assert _seq(tf, shp[k], d, A) == _seq(gf, shp[k], d, A)
    if not overlap:
        assert _seq(it.z_g, 6, dz, np.zeros((5, 5, 6))) == [6, 10, 2, 6, 10, 2]


def test_xyz_g_simulated_topology():
    """A 3x3x3 grid simulated by swapping in modified grid state."""
    g_ref, t = both_init(5, 5, 5, dimx=1, dimy=1, dimz=1, periodz=1)
    dims = (3, 3, 3)
    nxyz_g = tuple(dims[d] * (t.nxyz[d] - t.overlaps[d])
                   + t.overlaps[d] * (t.periods[d] == 0) for d in range(3))
    tshared.set_global_grid(dataclasses.replace(t, dims=dims, nxyz_g=nxyz_g,
                                                nprocs=27))
    igg.shared.set_global_grid(dataclasses.replace(g_ref, dims=dims,
                                                   nxyz_g=nxyz_g, nprocs=27))
    assert (it.nx_g(), it.ny_g(), it.nz_g()) == (11, 11, 9)
    dx, dy, dz = 20 / 10, 20 / 10, 16 / 8
    for A in (np.zeros((5, 5, 5)), np.zeros((6, 3, 7))):
        for c in [(0, 0, 0), (1, 0, 0), (2, 1, 2), (0, 2, 1)]:
            for tf, gf, d, k in ((it.x_g, igg.x_g, dx, 0),
                                 (it.y_g, igg.y_g, dy, 1),
                                 (it.z_g, igg.z_g, dz, 2)):
                assert _seq(tf, A.shape[k], d, A, c) == _seq(gf, A.shape[k],
                                                             d, A, c)
    assert _seq(it.z_g, 5, dz, np.zeros((5, 5, 5)), (0, 0, 2)) == [10, 12, 14, 16, 0]


@pytest.mark.parametrize("kw", [PERIODIC, {}, dict(periody=1)])
def test_coord_fields_match_igg(kw):
    both_init(4, 5, 6, **kw)
    Tg = igg.zeros((4, 5, 7))
    Tt = it.zeros((4, 5, 7))
    for a, b in zip(it.coord_fields(0.5, 0.25, 1.5, Tt),
                    igg.coord_fields(0.5, 0.25, 1.5, Tg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tic_toc():
    it.init_global_grid(4, 4, 4, quiet=True, device="cpu")
    it.tic()
    assert 0.0 <= it.toc() <= 1.0


def test_fields_layout_matches_igg():
    both_init(4, 5, 6)
    assert it.stacked_shape((4, 5, 6)) == igg.stacked_shape((4, 5, 6))
    rng = np.random.default_rng(1)
    blocks = {}

    def fn(coords, ls):
        return blocks.setdefault(coords, rng.standard_normal(ls))

    A = it.from_local_blocks(fn, (4, 5, 6), dtype=torch.float64)
    B = igg.from_local_blocks(fn, (4, 5, 6), dtype=np.float64)
    np.testing.assert_array_equal(it.local_blocks(A), np.asarray(B))
    np.testing.assert_array_equal(it.local_block(A, (1, 0, 1)),
                                  igg.local_block(B, (1, 0, 1)))
    assert it.full((4, 5, 6), 3.0).shape == A.shape
    assert float(it.ones((4, 5, 6)).sum()) == A.numel()


@pytest.mark.parametrize("n,kw,lshape,dtype", [
    ((4, 4, 4), dict(overlapx=0, overlapy=0, overlapz=0), (4, 4, 4), np.float64),
    ((4, 4, 1), dict(overlapx=0, overlapy=0), (4, 4), np.float64),
    ((6, 6, 6), {}, (6, 6, 6), np.float64),
    ((6, 6, 6), PERIODIC, (7, 6, 6), np.float64),
    ((6, 6, 6), dict(periody=1), (6, 6, 6), np.float32),
    ((6, 6, 6), dict(dimx=1, dimy=1, dimz=1), (6, 6, 6), np.float32),
])
def test_gather_matches_igg(n, kw, lshape, dtype):
    g, _ = both_init(*n, **kw)
    A = np.asarray(encoded_field(lshape, dtype=dtype))
    Ag = jax.device_put(A, igg.sharding_for(len(lshape)))
    At = torch.from_numpy(A.copy())
    np.testing.assert_array_equal(it.gather(At), igg.gather(Ag))
    np.testing.assert_array_equal(it.gather_interior(At), igg.gather_interior(Ag))
    out_t = np.zeros(A.shape, dtype=dtype)
    assert it.gather(At, out_t) is None
    np.testing.assert_array_equal(out_t, A)
    with pytest.raises(it.GridError, match="nprocs"):
        it.gather(At, np.zeros(3, dtype=dtype))


def test_sharded_local_step_matches_stacked():
    """`sharded` runs a local-block function on every block; its
    `update_halo_local` is a collective over the blocks."""
    _, t = both_init(6, 6, 6, periodx=1)
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal(it.stacked_shape((6, 6, 6))))

    xs = {}

    @it.sharded
    def local(B, scale):
        assert B.shape == (6, 6, 6)
        c = it.local_coords()
        # Inside a block, coordinates default to that block's.
        xs[c] = ([it.x_g(i, 0.5, B) for i in range(6)],
                 it.x_g_field(0.5, B).tolist())
        B = B * scale + float(c[0])
        return it.update_halo_local(B)

    out = local(A, 2.0)
    ref = A * 2.0
    ref[6:] += 1.0
    it.update_halo(ref)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert len(xs) == 8
    for c, (scalars, field) in xs.items():
        want = [igg.x_g(i, 0.5, np.zeros((6, 6, 6)), c) for i in range(6)]
        assert scalars == want and field == want
