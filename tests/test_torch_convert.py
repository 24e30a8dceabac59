"""State carried between igg and igg_torch (igg_torch.convert): stacked
numpy arrays in both directions, parameter dataclasses by field name, and
a run continued in the other package."""

import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg.models import diffusion3d as d3
from igg_torch import convert
from igg_torch.models import diffusion3d as t3
from torch_threads import one_torch_thread  # noqa: F401

PERIODIC = dict(periodx=1, periody=1, periodz=1)


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_round_trip_is_exact(dtype):
    it.init_global_grid(6, 6, 6, quiet=True, device="cpu", nprocs=8)
    rng = np.random.default_rng(7)
    arrays = {"T": (rng.standard_normal((12, 12, 12)) * 100).astype(dtype),
              "Vx": (rng.standard_normal((14, 12, 12)) * 100).astype(dtype)}
    tensors = convert.to_torch(arrays)
    assert all(t.device == torch.device("cpu") for t in tensors.values())
    back = convert.to_numpy(tensors)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(back[k], arrays[k])
    with pytest.raises(ValueError, match="divisible"):
        convert.to_torch({"bad": np.zeros((5, 12, 12))})


def test_params_carry_both_ways():
    p = d3.Params(lam=2.0, cp_min=0.5, lx=3.0, ly=4.0, lz=5.0)
    tp = convert.convert_params(p, t3.Params)
    assert isinstance(tp, t3.Params)
    assert convert.convert_params(tp, d3.Params) == p
    with pytest.raises(ValueError, match="lacks fields"):
        convert.convert_params(object(), t3.Params)


def test_run_continued_in_the_port_matches_igg():
    """3 steps in igg, then 3 more in igg and, from the carried state, in
    the port (float32; rtol 2e-6, atol 2e-5 as in tests/test_models.py)."""
    igg.init_global_grid(8, 8, 16, quiet=True, **PERIODIC)
    p = d3.Params(lx=4.0, ly=4.0, lz=8.0)
    T, Cp = d3.init_fields(p, dtype=np.float32)
    step3 = d3.make_multi_step(3, p, donate=False, use_pallas=False)
    T = step3(T, Cp)
    ref = np.asarray(step3(T, Cp))
    it.init_global_grid(8, 8, 16, quiet=True, device="cpu", nprocs=8, **PERIODIC)
    st = convert.to_torch({"T": np.asarray(T), "Cp": np.asarray(Cp)})
    tp = convert.convert_params(p, t3.Params)
    out = t3.make_multi_step(3, tp)(st["T"], st["Cp"])
    np.testing.assert_allclose(convert.to_numpy({"T": out})["T"], ref,
                               rtol=2e-6, atol=2e-5)
