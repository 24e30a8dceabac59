"""The port's halo engine (igg_torch.update_halo) held BITWISE against
igg.update_halo on the CPU.  The same numpy input goes through both: the
coordinate-encoded oracle of tests/test_update_halo.py (halos zeroed, then
restored by the update) and random data (which the oracle cannot tell
corner mistakes at open edges from).  On the CPU the port's halo writer
runs its plain version; tests/test_torch_kernels.py holds the kernel
against it on a card."""

import jax
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg_torch import halo as thalo
from igg_torch.ops import halo_write

from helpers import encoded_field, expected_after_update, zero_halo_blocks
from torch_threads import one_torch_thread  # noqa: F401

PERIODIC = dict(periodx=1, periody=1, periodz=1)
SINGLE = dict(dimx=1, dimy=1, dimz=1)
OL3 = dict(overlapx=3, overlapy=3, overlapz=3)
STOKES_SHAPES = [(8, 8, 8), (9, 8, 8), (8, 9, 8), (8, 8, 9)]


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(n, kw):
    igg.init_global_grid(*n, quiet=True, **kw)
    g = igg.get_global_grid()
    it.init_global_grid(*n, quiet=True, device="cpu", nprocs=g.nprocs, **kw)
    return g


def igg_update(*arrays):
    outs = igg.update_halo(*(jax.device_put(a, igg.sharding_for(a.ndim))
                             for a in arrays))
    return [np.asarray(o) for o in (outs if len(arrays) > 1 else (outs,))]


def port_update(*arrays):
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    it.update_halo(*ts)
    return [t.numpy() for t in ts]


# (local grid size, init kwargs, field local shape): the oracle matrix.
ORACLE_CASES = {
    "3d_periodic_8blocks": ((6, 6, 6), PERIODIC, (6, 6, 6)),
    "3d_periodic_1block": ((6, 6, 6), dict(SINGLE, **PERIODIC), (6, 6, 6)),
    "3d_open_8blocks": ((6, 6, 6), {}, (6, 6, 6)),
    "3d_open_1block": ((6, 6, 6), SINGLE, (6, 6, 6)),
    "3d_mixed": ((6, 6, 6), dict(periody=1), (6, 6, 6)),
    "3d_mixed_1block": ((6, 6, 6), dict(SINGLE, periodx=1, periodz=1), (6, 6, 6)),
    "staggered_x": ((6, 6, 6), PERIODIC, (7, 6, 6)),
    "staggered_y": ((6, 6, 6), PERIODIC, (6, 7, 6)),
    "staggered_z_open": ((6, 6, 6), {}, (6, 6, 7)),
    "overlap3": ((8, 8, 8), dict(PERIODIC, overlapx=3, overlapz=4), (8, 8, 8)),
    "overlap3_1block": ((8, 8, 8), dict(SINGLE, **PERIODIC, overlapx=3), (8, 8, 8)),
    "no_halo_dims": ((6, 6, 6), PERIODIC, (6, 5, 5)),
    "2d_periodic": ((6, 6, 1), dict(periodx=1, periody=1), (6, 6)),
    "2d_open": ((6, 6, 1), {}, (6, 6)),
    # wave2d's staggered velocities: Vx (x overlap 3), Vy (y overlap 3).
    "2d_staggered_x_periodic": ((6, 6, 1), dict(periodx=1, periody=1), (7, 6)),
    "2d_staggered_y_periodic": ((6, 6, 1), dict(periodx=1, periody=1), (6, 7)),
    "2d_staggered_x_open": ((6, 6, 1), {}, (7, 6)),
    "2d_staggered_y_open": ((6, 6, 1), {}, (6, 7)),
    "2d_staggered_x_1block": ((6, 6, 1), dict(SINGLE, periodx=1, periody=1),
                              (7, 6)),
    "2d_staggered_y_1block": ((6, 6, 1), dict(SINGLE, periodx=1, periody=1),
                              (6, 7)),
    # stokes3d's grid: overlap 3 in all dims, velocities staggered along x,
    # y or z (overlap 4 in their own dim, halo planes one row deeper).
    "stokes_overlap3_periodic": ((8, 8, 8), dict(PERIODIC, **OL3), (8, 8, 8)),
    "stokes_overlap3_open": ((8, 8, 8), OL3, (8, 8, 8)),
    "stokes_vx_periodic": ((8, 8, 8), dict(PERIODIC, **OL3), (9, 8, 8)),
    "stokes_vy_periodic": ((8, 8, 8), dict(PERIODIC, **OL3), (8, 9, 8)),
    "stokes_vz_periodic": ((8, 8, 8), dict(PERIODIC, **OL3), (8, 8, 9)),
    "stokes_vx_open": ((8, 8, 8), OL3, (9, 8, 8)),
    "stokes_vy_open": ((8, 8, 8), OL3, (8, 9, 8)),
    "stokes_vz_open": ((8, 8, 8), OL3, (8, 8, 9)),
    "stokes_vx_1block": ((8, 8, 8), dict(SINGLE, **PERIODIC, **OL3),
                         (9, 8, 8)),
    "stokes_vy_1block": ((8, 8, 8), dict(SINGLE, **PERIODIC, **OL3),
                         (8, 9, 8)),
    "stokes_vz_1block": ((8, 8, 8), dict(SINGLE, **PERIODIC, **OL3),
                         (8, 8, 9)),
    "1d_periodic": ((6, 1, 1), dict(periodx=1), (6,)),
    "1d_open": ((6, 1, 1), {}, (6,)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_matches_igg_bitwise(case, dtype):
    n, kw, lshape = ORACLE_CASES[case]
    init_both(n, kw)
    field = np.asarray(encoded_field(lshape, dtype=dtype))
    zeroed = zero_halo_blocks(field, lshape).astype(dtype)
    ref, = igg_update(zeroed)
    out, = port_update(zeroed)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, expected_after_update(field, zeroed, lshape).astype(dtype))


@pytest.mark.parametrize("kw", [
    {}, PERIODIC, dict(periody=1), dict(periodx=1, periodz=1),
    dict(dimy=1, dimz=1, periody=1), dict(periodz=1, disp=2, dimx=4, dimy=2),
    dict(SINGLE, periody=1),
], ids=["open", "periodic", "periody", "periodxz", "dimy1", "disp2", "single"])
@pytest.mark.parametrize("lshape", [(6, 6, 6), (7, 6, 6)])
def test_random_data_matches_igg_bitwise(kw, lshape):
    init_both((6, 6, 6), kw)
    rng = np.random.default_rng(42)
    A = rng.standard_normal(it.stacked_shape(lshape))
    ref, = igg_update(A)
    out, = port_update(A)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kw", [PERIODIC, {}, dict(SINGLE, **PERIODIC)])
def test_two_fields_grouped(kw):
    init_both((6, 6, 6), kw)
    rng = np.random.default_rng(3)
    A = rng.standard_normal(it.stacked_shape((6, 6, 6)))
    B = rng.standard_normal(it.stacked_shape((7, 6, 6)))
    ref = igg_update(A, B)
    out = port_update(A, B)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [dict(periodx=1, periody=1), {},
                                dict(SINGLE, periodx=1, periody=1)],
                         ids=["periodic", "open", "periodic_1block"])
def test_wave2d_fields_grouped_oracle(kw, dtype):
    """wave2d's three fields P (6,6), Vx (7,6) and Vy (6,7) in ONE grouped
    call on a 2-D grid: the coordinate-encoded oracle, bitwise against
    igg."""
    init_both((6, 6, 1), kw)
    lshapes = [(6, 6), (7, 6), (6, 7)]
    fields = [np.asarray(encoded_field(s, dtype=dtype)) for s in lshapes]
    zeroed = [zero_halo_blocks(f, s).astype(dtype)
              for f, s in zip(fields, lshapes)]
    ref = igg_update(*zeroed)
    out = port_update(*zeroed)
    for o, r, f, z, s in zip(out, ref, fields, zeroed, lshapes):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(
            o, expected_after_update(f, z, s).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [dict(PERIODIC, **OL3), OL3,
                                dict(SINGLE, **PERIODIC, **OL3),
                                dict(dimx=4, dimy=2, dimz=1, periodx=1,
                                     periodz=1, **OL3)],
                         ids=["periodic", "open", "periodic_1block",
                              "mixed_4x2x1"])
def test_stokes_fields_grouped_oracle(kw, dtype):
    """stokes3d's four exchanged fields P (8,8,8), Vx (9,8,8), Vy (8,9,8)
    and Vz (8,8,9) on an overlap-3 grid in ONE grouped call: the
    coordinate-encoded oracle, bitwise against igg."""
    init_both((8, 8, 8), kw)
    fields = [np.asarray(encoded_field(s, dtype=dtype))
              for s in STOKES_SHAPES]
    zeroed = [zero_halo_blocks(f, s).astype(dtype)
              for f, s in zip(fields, STOKES_SHAPES)]
    ref = igg_update(*zeroed)
    out = port_update(*zeroed)
    for o, r, f, z, s in zip(out, ref, fields, zeroed, STOKES_SHAPES):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(
            o, expected_after_update(f, z, s).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [dict(PERIODIC, **OL3), OL3,
                                dict(SINGLE, **PERIODIC, **OL3),
                                dict(SINGLE, periodx=1, periodz=1, **OL3)],
                         ids=["periodic", "open", "periodic_1block",
                              "mixed_1block"])
def test_stokes_fields_grouped_random(kw, dtype):
    """The same four staggered fields with random data (which the oracle
    cannot tell corner mistakes at open edges from), bitwise against
    igg."""
    init_both((8, 8, 8), kw)
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(it.stacked_shape(s)).astype(dtype)
              for s in STOKES_SHAPES]
    for o, r in zip(port_update(*arrays), igg_update(*arrays)):
        np.testing.assert_array_equal(o, r)


def test_returns_the_updated_tensor_in_place():
    init_both((6, 6, 6), PERIODIC)
    A = it.zeros((6, 6, 6))
    assert it.update_halo(A) is A
    B = it.zeros((6, 6, 6))
    assert it.update_halo(A, B) == (A, B)


def test_argument_checks_match_igg():
    init_both((8, 8, 8), {})
    A = it.zeros((8, 8, 8))
    B = it.zeros((7, 6, 6))
    with pytest.raises(it.GridError, match="position 1 has no halo"):
        it.update_halo(A, B)
    with pytest.raises(it.GridError, match="has no halo"):
        it.update_halo(B)
    with pytest.raises(it.GridError, match="duplicate"):
        it.update_halo(A, A)
    with pytest.raises(it.GridError, match="different type"):
        it.update_halo(A, it.zeros((8, 8, 8), dtype=torch.float64))
    it.finalize_global_grid()
    with pytest.raises(it.GridError, match="init_global_grid"):
        it.update_halo(A)


def test_exchange_planes_matches_igg_on_one_axis():
    """The wire function alone: stacked planes of 4 blocks along x, open
    and periodic, disp 1 and 2, against igg's ppermute shift."""
    from jax.sharding import PartitionSpec as P

    init_both((6, 6, 6), dict(dimx=4, dimy=2, dimz=1))
    g = igg.get_global_grid()
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal((4, 12, 6)) for _ in range(4)]
    for periodic in (False, True):
        for disp in (1, 2):
            spec = P("gx")
            fn = jax.jit(jax.shard_map(
                lambda a, b, c, d: igg.halo.exchange_planes(
                    a, b, c, d, 0, 4, periodic, disp),
                mesh=g.mesh, in_specs=(spec,) * 4, out_specs=(spec, spec),
                check_vma=False))
            ref = fn(*planes)
            out = thalo.exchange_planes(*(torch.from_numpy(p) for p in planes),
                                        0, 4, periodic, disp)
            for o, r in zip(out, ref):
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_writer_plain_dimension_order():
    """The halo writer's plain version on one block: dims in order, later
    dims win, wrap sources read after the earlier dims' writes."""
    it.init_global_grid(5, 6, 7, quiet=True, device="cpu", **SINGLE)
    A = torch.arange(5 * 6 * 7, dtype=torch.float64).reshape(5, 6, 7)
    ext0 = (torch.full((1, 6, 7), -1.0, dtype=torch.float64),
            torch.full((1, 6, 7), -2.0, dtype=torch.float64))
    B = halo_write.halo_write_plain(A.clone(), [(0, "ext", *ext0),
                                                (2, "wrap", 2)], (1, 1, 1))
    assert float(B[0, 3, 3]) == -1.0 and float(B[4, 3, 3]) == -2.0
    assert float(B[0, 3, 0]) == -1.0          # z wraps the x-written plane
    assert torch.equal(B[2, :, 0], A[2, :, 5]) and torch.equal(B[2, :, 6], A[2, :, 1])
    assert torch.equal(B[1:4, :, 1:6], A[1:4, :, 1:6])
    with pytest.raises(ValueError, match="increasing"):
        halo_write.halo_write_plain(A.clone(), [(2, "wrap", 2), (0, "wrap", 2)],
                                    (1, 1, 1))
