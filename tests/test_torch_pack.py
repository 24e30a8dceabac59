"""The port's plane packer held against igg on the CPU.

The packer's plain version (what runs on the CPU) gives igg's planes: every
block's local plane `pos` along y or z, `igg.halo._plane` under
`igg.sharded`, stacked over the blocks.  `update_halo` on y/z-split grids,
where the halo engine now extracts its y/z send and stale planes through
the packer, stays bitwise equal to `igg.update_halo`, and the fused step's
stale planes take the packer under the same rule (two or more y/z planes).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import igg
import igg_torch as it
from igg.halo import _plane
from igg_torch import convert
from igg_torch.ops import diffusion_pallas as dp
from igg_torch.ops import pack

PERIODIC = dict(periodx=1, periody=1, periodz=1)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def init_both(local, kw):
    igg.init_global_grid(*local, quiet=True, **kw)
    it.init_global_grid(*local, quiet=True, device="cpu", **kw)
    return it.get_global_grid()


def random_field(local, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return igg.from_local_blocks(lambda c, ls: rng.uniform(-100, 100, ls),
                                 local, dtype=dtype)


@pytest.fixture
def pack_calls(monkeypatch):
    """Records the request lists the packer is called with."""
    calls = []
    real = pack.pack_planes

    def spy(A, reqs, blocks):
        calls.append(list(reqs))
        return real(A, reqs, blocks)

    monkeypatch.setattr(pack, "pack_planes", spy)
    return calls


@pytest.mark.parametrize("kw", [dict(dimx=2, dimy=2, dimz=2),
                                dict(dimx=1, dimy=2, dimz=4, **PERIODIC)],
                         ids=["2x2x2", "1x2x4"])
def test_plain_packer_gives_igg_planes(kw):
    local = (6, 7, 9)
    g = init_both(local, kw)
    A = random_field(local, 1)
    reqs = [(d, p) for d in (1, 2) for p in (0, 1, local[d] - 2, local[d] - 1)]
    At = convert.to_torch({"A": np.asarray(A)})["A"]
    got = pack.pack_planes(At, reqs, g.dims)
    for (d, p), P_t in zip(reqs, got):
        want = igg.sharded(lambda A: _plane(A, d, p),
                           out_specs=P(*igg.AXIS_NAMES), check_vma=False)(A)
        np.testing.assert_array_equal(P_t.numpy(), np.asarray(want))


def test_packer_rejects_bad_requests():
    it.init_global_grid(6, 7, 9, quiet=True, device="cpu", dimx=2, dimy=2,
                        dimz=2)
    A = torch.zeros(it.stacked_shape((6, 7, 9)))
    for reqs in ([(0, 1)], [(1, 7)], [(2, -1)], [], [(1, 0)] * 9):
        with pytest.raises(ValueError):
            pack.pack_planes(A, reqs, (2, 2, 2))
    with pytest.raises(ValueError):
        pack.pack_planes(torch.zeros(12, 14), [(1, 0)], (2, 2, 1))


# y/z-split grids, open and periodic; (local grid, init kwargs)
SPLIT = {
    "2x2x2_open": dict(dimx=2, dimy=2, dimz=2),
    "2x2x2_periodic": dict(dimx=2, dimy=2, dimz=2, **PERIODIC),
    "1x2x2_open": dict(dimx=1, dimy=2, dimz=2),
    "1x2x2_periodic": dict(dimx=1, dimy=2, dimz=2, **PERIODIC),
}


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT))
def test_update_halo_through_packer_matches_igg(case, dtype, pack_calls):
    local = (6, 7, 8)
    init_both(local, SPLIT[case])
    jdt = jax.numpy.dtype(dtype)
    A = np.asarray(random_field(local, 2)).astype(jdt)
    ref = np.asarray(igg.update_halo(
        jax.device_put(A, igg.sharding_for(3))))
    At = torch.from_numpy(A.astype(np.float64)).to(getattr(torch, dtype))
    it.update_halo(At)
    np.testing.assert_array_equal(At.to(torch.float64).numpy(),
                                  ref.astype(np.float64))
    periodic = "periodic" in case
    # y and z: send planes of both sides, and stale planes where open
    assert [len(r) for r in pack_calls] == [4 if periodic else 8]


def test_fused_step_stale_planes_take_packer(pack_calls):
    """Open y/z recv dims: the step's four stale planes in one pack."""
    it.init_global_grid(8, 8, 16, quiet=True, device="cpu", dimx=2, dimy=2,
                        dimz=2)
    g = it.get_global_grid()
    T = torch.rand(it.stacked_shape(g.nxyz), dtype=torch.float64)
    A = torch.full_like(T, 0.05)
    sc = dp.scal(0.3, 0.4, 0.5)
    dp.step_recv_planes(T, A, g, dp.step_modes(g), sc)
    assert pack_calls == [[(1, 0), (1, 7), (2, 0), (2, 15)]]
