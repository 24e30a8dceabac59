"""The port's bounded fetch (igg_torch.gather) held against igg's on the
CPU: the slab axis, the slab fetch at a small limit against the whole
fetch (any dtype, whole tensors and block views), `gather` and
`gather_interior` through the slab path against igg's on the same state,
and the halo byte accounting's cache across a finalize.  Bitwise
throughout."""

import importlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.fields import sharding_for
from igg.gather import _stream_axis as igg_stream_axis
from igg_torch import halo as thalo
from igg_torch import telemetry as tel
from torch_threads import one_torch_thread  # noqa: F401

tgather = importlib.import_module("igg_torch.gather")

PERIODS = {"periodic": dict(periodx=1, periody=1, periodz=1),
           "mixed": dict(periodx=1), "open": {}}


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


@pytest.mark.parametrize("shape", [(), (1,), (1, 1, 1), (7,), (1, 8, 3),
                                   (5, 2, 9), (3, 3, 3), (2, 9, 9, 4)])
def test_stream_axis_matches_igg(shape):
    assert tgather._stream_axis(shape) == igg_stream_axis(shape)


def _tensor(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 50
    if dtype == torch.bool:
        return torch.from_numpy(a > 0)
    if dtype == torch.complex64:
        return torch.from_numpy((a + 1j * a[::-1]).astype(np.complex64))
    return torch.from_numpy(a).to(dtype)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("view", ["whole", "block", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int32, torch.bool,
                                   torch.complex64])
def test_slabbed_get_equals_whole_fetch(dtype, view, monkeypatch):
    """At a limit of a few rows the fetch goes in many slabs over the
    largest dim and equals the whole fetch bit for bit; the result is a
    fresh array, never a view of the tensor."""
    A = _tensor((12, 10, 18), dtype, 1)
    if view == "block":
        A = A[6:12, 5:10, 9:18]
    elif view == "strided":
        A = A[::2, 1:, ::3]
    slabs = []
    real = tgather._slab_index

    def spy(*args):
        slabs.append(args)
        return real(*args)

    monkeypatch.setattr(tgather, "_slab_index", spy)
    row = A.element_size() * int(np.prod(A.shape)) // max(A.shape)
    got = tgather._slabbed_get(A, 3 * row)
    monkeypatch.undo()
    axis = tgather._stream_axis(tuple(A.shape))
    assert len(slabs) == -(-A.shape[axis] // 3)
    want = _bits(A.contiguous())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.flags.c_contiguous
    assert not np.shares_memory(got, A.numpy() if A.dtype != torch.bfloat16
                                else A.view(torch.int16).numpy())
    np.testing.assert_array_equal(tgather._slabbed_get(A, 1 << 30), want)


def _both_init(n, kw):
    igg.init_global_grid(*n, quiet=True, **kw)
    it.init_global_grid(*n, quiet=True, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)


@pytest.mark.parametrize("lshape", [(6, 6, 6), (7, 6, 6), (6, 5, 7, 2)])
@pytest.mark.parametrize("periods", sorted(PERIODS))
def test_gather_through_slabs_matches_igg(periods, lshape, monkeypatch):
    """`gather` and `gather_interior` with the slab limit cut to a few
    rows equal igg's on the same stacked state; `gather` into `A_global`
    too."""
    _both_init((6, 6, 6) if len(lshape) == 3 else (6, 5, 7),
               PERIODS[periods])
    g = igg.get_global_grid()
    shp = tuple(s * (g.dims[d] if d < 3 else 1) for d, s in enumerate(lshape))
    a = np.random.default_rng(2).standard_normal(shp)
    Ag, At = jax.device_put(a, sharding_for(a.ndim)), torch.from_numpy(a)
    monkeypatch.setattr(tgather, "_CHUNK_BYTES", 3 * a.nbytes // max(shp))
    np.testing.assert_array_equal(it.gather(At), igg.gather(Ag))
    np.testing.assert_array_equal(it.gather_interior(At),
                                  igg.gather_interior(Ag))
    out = np.zeros(a.size)
    assert it.gather(At, out) is None
    np.testing.assert_array_equal(out, np.asarray(igg.gather(Ag)).ravel())
    igg.finalize_global_grid()


def test_gather_bfloat16_is_exact_float32_of_igg():
    """A bfloat16 field gathers to its exact float32 values (numpy has no
    bfloat16 type in the port): igg's bfloat16 gather, upcast, bitwise;
    the checkpoint's internal fetch keeps the raw bits."""
    _both_init((6, 6, 6), {})
    a = np.random.default_rng(3).standard_normal((12, 12, 12)).astype(
        ml_dtypes.bfloat16)
    Ag = jax.device_put(a, sharding_for(3))
    At = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    for got, want in ((it.gather_interior(At), igg.gather_interior(Ag)),
                      (it.gather(At), igg.gather(Ag))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got.view(np.int32), np.asarray(want).astype(np.float32).view(
                np.int32))
    out = np.zeros(a.size, dtype=np.float32)
    assert it.gather(At, out) is None
    np.testing.assert_array_equal(out, a.astype(np.float32).ravel())
    np.testing.assert_array_equal(tgather._fetch_global(At),
                                  a.view(np.int16))
    igg.finalize_global_grid()


def test_gather_float8_is_exact_float32():
    """A float8 field gathers to its exact float32 values, every one of
    its 256 bit patterns but the NaN among them."""
    it.init_global_grid(6, 6, 6, nprocs=8, device="cpu", quiet=True)
    codes = np.arange(12 ** 3, dtype=np.int64) % 256
    codes[(codes & 0x7F) == 0x7F] = 0          # e4m3fn's NaN patterns
    A = torch.from_numpy(codes.astype(np.uint8).reshape(12, 12, 12)).view(
        torch.float8_e4m3fn)
    got = it.gather(A)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, A.to(torch.float32).numpy())
    it.finalize_global_grid()


def test_free_gather_buffer():
    tgather.free_gather_buffer()
    assert tgather._pinned is None
    it.init_global_grid(6, 6, 6, nprocs=8, device="cpu", quiet=True)
    it.gather(it.ones((6, 6, 6)))
    assert tgather._pinned is None        # the CPU path pins nothing


def _plane_bytes():
    return tel.snapshot().get("igg_halo_plane_bytes_total",
                              {}).get("value", 0.0)


def test_finalize_clears_the_plane_byte_cache():
    """`finalize_global_grid` empties the halo byte accounting's cache, and
    the next grid's `update_halo` counts its own bytes, igg's count."""
    tel.reset_metrics()
    it.init_global_grid(6, 6, 6, nprocs=8, device="cpu", quiet=True)
    it.update_halo(it.zeros((6, 6, 6)))
    assert thalo._PLANE_BYTES
    it.finalize_global_grid()
    assert not thalo._PLANE_BYTES
    for n, kw in (((10, 6, 4), dict(dimx=1, dimy=2, dimz=4, periodx=1)),
                  ((6, 6, 6), dict(periodz=1))):
        _both_init(n, kw)
        before = _plane_bytes()
        it.update_halo(it.zeros(n))
        got = _plane_bytes() - before
        from igg import telemetry as igg_tel
        b0 = igg_tel.snapshot().get("igg_halo_plane_bytes_total",
                                    {}).get("value", 0.0)
        igg.update_halo(igg.zeros(n))
        want = igg_tel.snapshot()["igg_halo_plane_bytes_total"]["value"] - b0
        assert got == want > 0
        assert len(thalo._PLANE_BYTES) == 1
        igg.finalize_global_grid()
        it.finalize_global_grid()
