"""The port's checkpoint (igg_torch.checkpoint) held against igg's on the
CPU.

Both packages write the same files: a generation one writes loads in the
other, flat and sharded, bitwise, and both redistribute it onto another
decomposition to the same arrays, halos included.  The manifests agree
key by key but for the attempt token.  Then the counterparts of igg's own
cases (tests/test_checkpoint.py), the snapshot contract (a save holds the
state of the call after the fields change in place), the bounded staging
of the sharded paths, the generation scan, the stale sweep and the
telemetry.  igg runs on its 8 virtual CPU devices, the port with
`device="cpu"` and the same 8 blocks stacked; inputs come from a seeded
numpy generator; every comparison is bitwise.
"""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igg
import igg_torch as it
from igg import chaos
from igg import telemetry as igg_tel
from igg.fields import sharding_for
from igg_torch import checkpoint as ck
from igg_torch import telemetry as tel
from igg_torch.models import diffusion3d as t3
from torch_threads import one_torch_thread  # noqa: F401

PERIODS = {"periodic": dict(periodx=1, periody=1, periodz=1),
           "mixed": dict(periodx=1), "open": {}}
DTYPES = ("float32", "float64", "bfloat16")


@pytest.fixture(autouse=True)
def _clean_torch_grid():
    if it.grid_is_initialized():
        it.finalize_global_grid()
    yield
    if it.grid_is_initialized():
        it.finalize_global_grid()


def both_init(nx, ny, nz, **kw):
    for pkg in (igg, it):
        if pkg.grid_is_initialized():
            pkg.finalize_global_grid()
    igg.init_global_grid(nx, ny, nz, quiet=True, **kw)
    it.init_global_grid(nx, ny, nz, quiet=True, device="cpu",
                        nprocs=igg.get_global_grid().nprocs, **kw)


def both_finalize():
    igg.finalize_global_grid()
    it.finalize_global_grid()


def bits(a: np.ndarray) -> np.ndarray:
    """`a` as raw bits (bfloat16 has no numpy type in the port)."""
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def to_jax(a):
    return jax.device_put(a, sharding_for(a.ndim))


def to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def host(t):
    """A tensor or jax array as a numpy array of raw bits where numpy has
    no type."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return bits(np.asarray(t))


def state(dtype, seed=11):
    """Stacked fields on the current (2,2,2) grid of 6^3 blocks: T in
    `dtype`, a staggered Vx and a rank-4 U (float64)."""
    rng = np.random.default_rng(seed)
    g = igg.get_global_grid()
    shp = lambda ls: tuple(s * (g.dims[d] if d < 3 else 1)
                           for d, s in enumerate(ls))
    T = rng.standard_normal(shp((6, 6, 6))).astype(
        jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype))
    return {"T": T, "Vx": rng.standard_normal(shp((7, 6, 6))),
            "U": rng.standard_normal(shp((6, 6, 6, 2)))}


def save(writer, fmt, path, arrays):
    pkg, conv = (igg, to_jax) if writer == "igg" else (it, to_torch)
    fields = {k: conv(v) for k, v in arrays.items()}
    (pkg.save_checkpoint if fmt == "flat" else pkg.save_checkpoint_sharded)(
        path, **fields)


def gen_path(tmp_path, fmt, name="gen"):
    return tmp_path / (f"{name}.npz" if fmt == "flat" else name)


def same(got, want):
    np.testing.assert_array_equal(host(got), host(want))
    assert host(got).dtype == host(want).dtype


# -- cross-loading ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periods", sorted(PERIODS))
@pytest.mark.parametrize("writer", ["igg", "port"])
@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_cross_load(tmp_path, fmt, writer, periods, dtype):
    """A checkpoint one package writes loads in both, bitwise, and both
    verify it (CRC, finite, deep stamp)."""
    both_init(6, 6, 6, **PERIODS[periods])
    arrays = state(dtype)
    path = gen_path(tmp_path, fmt)
    save(writer, fmt, path, arrays)
    a, b = igg.load_checkpoint(path), it.load_checkpoint(path)
    assert set(a) == set(b) == set(arrays)
    for name, want in arrays.items():
        same(b[name], want)
        same(a[name], want)
        assert b[name].device.type == "cpu"
    assert b["T"].dtype == {"float32": torch.float32,
                            "float64": torch.float64,
                            "bfloat16": torch.bfloat16}[dtype]
    for pkg in (igg, it):
        assert pkg.verify_checkpoint(path, check_finite=True, deep=True)
    it.update_halo(b["T"])    # restored fields are live
    both_finalize()


@pytest.mark.parametrize("target", [(1, 2, 4), (4, 2, 1)])
@pytest.mark.parametrize("periods", sorted(PERIODS))
@pytest.mark.parametrize("writer", ["igg", "port"])
@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_cross_elastic(tmp_path, fmt, writer, periods, target):
    """A (2,2,2) checkpoint of one package redistributed onto `target` by
    the port equals igg's own redistribute of it, halo cells included, and
    its interior equals the source's `gather_interior`."""
    kw = PERIODS[periods]
    both_init(6, 6, 6, **kw)
    arrays = state("float64", seed=12)
    path = gen_path(tmp_path, fmt)
    save(writer, fmt, path, arrays)
    want_i = {k: np.asarray(igg.gather_interior(to_jax(v)))
              for k, v in arrays.items()}
    local = [2 * 4 // n + 2 for n in target]
    both_init(*local, dimx=target[0], dimy=target[1], dimz=target[2], **kw)
    a = igg.load_checkpoint(path, redistribute=True)
    b = it.load_checkpoint(path, redistribute=True)
    for name in arrays:
        same(b[name], a[name])
        np.testing.assert_array_equal(it.gather_interior(b[name]),
                                      want_i[name])
    both_finalize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periods", sorted(PERIODS))
def test_manifests_agree(tmp_path, periods, dtype):
    """The same state saved by both packages: the sharded manifests agree
    key by key but for the attempt token, every shard's meta (per-field
    CRCs, coords, dtypes, deep stamps) agrees, and the flat files' meta
    entries are the same bytes."""
    both_init(6, 6, 6, **PERIODS[periods])
    arrays = state(dtype, seed=13)
    for writer in ("igg", "port"):
        save(writer, "sharded", tmp_path / writer, arrays)
        save(writer, "flat", tmp_path / f"{writer}.npz", arrays)
    mi = json.loads((tmp_path / "igg" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert list(mi) == list(mt)
    assert {k: v for k, v in mi.items() if k != "attempt"} == \
        {k: v for k, v in mt.items() if k != "attempt"}
    assert mi["attempt"] != mt["attempt"]
    names = sorted(p.name for p in (tmp_path / "igg").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for fname in names:
        if fname.endswith(".npz"):
            assert ck._read_shard_meta(tmp_path / "igg" / fname) == \
                ck._read_shard_meta(tmp_path / "port" / fname)
    with np.load(tmp_path / "igg.npz") as zi, np.load(tmp_path / "port.npz") \
            as zt:
        assert zi.files == zt.files
        assert bytes(zi["__igg_meta__"]) == bytes(zt["__igg_meta__"])
    assert (tmp_path / "igg.npz").stat().st_size == \
        (tmp_path / "port.npz").stat().st_size
    both_finalize()


def test_igg_invariant_stamps_verify_in_port(tmp_path):
    """A generation whose manifest carries igg's invariant stamps verifies
    deep in the port exactly when it does in igg: within tolerance of its
    reference it passes, drifted it fails."""
    both_init(6, 6, 6, periodx=1)
    arrays = state("float64", seed=14)
    save("igg", "sharded", tmp_path / "gen", arrays)
    man_path = tmp_path / "gen" / "manifest.json"
    man = json.loads(man_path.read_text())
    total = man["deep"]["sums"]["T"][0]
    for ref, ok in ((total + 1e-6, True), (total + 1.0, False)):
        man["deep"]["invariants"] = [{"fields": ["T"], "moment": 1,
                                      "ref": ref, "scale": 1.0,
                                      "tol": 1e-3, "kind": "conserved"}]
        man_path.write_text(json.dumps(man))
        assert igg.verify_checkpoint(tmp_path / "gen", deep=True) is ok
        assert it.verify_checkpoint(tmp_path / "gen", deep=True) is ok
    both_finalize()


def test_deep_stats_bitwise_igg():
    """The port's bounded moment sums equal igg's whole-array ones bit for
    bit: float32, float64 (contiguous and strided), bfloat16, complex,
    bool, sizes below and across numpy's reduction buffers."""
    from igg import checkpoint as ick

    rng = np.random.default_rng(15)
    big = rng.standard_normal((40, 70, 33))
    cases = [big, big[:-3, 1:, :-2], big.astype(np.float32)[2:, :-5, 1:],
             big[:1, :3, :5], (big[:9, :9, :9] + 1j * big[1:10, :9, :9]),
             big[:9, :9, :9] > 0, np.zeros((0, 4))]
    for a in cases:
        np.testing.assert_array_equal(ck._deep_stats(a), ick._deep_stats(a))
    b = big[:20, :20, :20].astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        ck._deep_stats(b.view(np.int16)[1:, :-1], torch.bfloat16),
        ick._deep_stats(b[1:, :-1]))


# -- igg's own cases (tests/test_checkpoint.py) ------------------------------

def _encoded(lshape):
    """igg's coordinate-encoded field on the current grid, both packages."""
    from helpers import encoded_field

    A = igg.update_halo(encoded_field(lshape))
    return A, to_torch(np.asarray(A))


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_roundtrip(tmp_path, fmt):
    both_init(6, 6, 6, periodx=1)
    arrays = state("float64", seed=21)
    path = gen_path(tmp_path, fmt)
    save("port", fmt, path, arrays)
    out = it.load_checkpoint(path)
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        same(out[k], v)
    it.update_halo(out["T"])


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_resume_continues_identically(tmp_path, fmt):
    """A diffusion run resumed from a checkpoint continues bit for bit
    (igg's case, on the port's model: its plain path on the CPU)."""
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1,
                        periody=1, periodz=1, device="cpu", quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    step = t3.make_multi_step(3, p, use_kernels=False)
    T = step(T, Cp)
    path = gen_path(tmp_path, fmt)
    (it.save_checkpoint if fmt == "flat" else it.save_checkpoint_sharded)(
        path, T=T, Cp=Cp)
    ref = step(T, Cp).clone()
    got = it.load_checkpoint(path)
    np.testing.assert_array_equal(step(got["T"], got["Cp"]).numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_elastic_resume_continues_identically(tmp_path, fmt):
    """igg's elastic contract on the port's diffusion model (the card
    phase's run at a small size): 2x2x2 open blocks of 12^3, two calls of
    `make_multi_step(17)`, a save, two more calls; the generation loaded
    onto (1,2,4) blocks of the same global grid and run two calls gives
    the same interior, bitwise."""
    it.init_global_grid(12, 12, 12, dimx=2, dimy=2, dimz=2, device="cpu",
                        quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    step = t3.make_multi_step(17, p)
    T = step(step(T, Cp), Cp)
    path = gen_path(tmp_path, fmt)
    (it.save_checkpoint if fmt == "flat" else it.save_checkpoint_sharded)(
        path, T=T, Cp=Cp)
    want = it.gather_interior(step(step(T, Cp), Cp))
    it.finalize_global_grid()
    it.init_global_grid(22, 12, 7, dimx=1, dimy=2, dimz=4, device="cpu",
                        quiet=True)
    got = it.load_checkpoint(path, redistribute=True)
    step = t3.make_multi_step(17, p)
    T = step(step(got["T"], got["Cp"]), got["Cp"])
    np.testing.assert_array_equal(it.gather_interior(T), want)


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_geometry_mismatch_rejected(tmp_path, fmt):
    both_init(6, 6, 6)
    path = gen_path(tmp_path, fmt)
    save("port", fmt, path, {"T": state("float64")["T"]})
    it.finalize_global_grid()
    it.init_global_grid(6, 6, 6, periodx=1, nprocs=8, device="cpu",
                        quiet=True)
    with pytest.raises(it.GridError, match="geometry mismatch"):
        it.load_checkpoint(path)
    it.finalize_global_grid()
    it.init_global_grid(8, 6, 6, nprocs=8, device="cpu", quiet=True)
    with pytest.raises(it.GridError, match="geometry mismatch"):
        it.load_checkpoint(path)
    both_finalize()


@pytest.mark.parametrize("target", [(1, 1, 1), (4, 2, 1)])
@pytest.mark.parametrize("periods", sorted(PERIODS))
@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_redistribute_bit_identical_interiors(tmp_path, fmt, periods,
                                              target):
    """igg's TestRedistribute: save on (2,2,2), restore onto `target`; the
    interiors equal the source's `gather_interior`, the whole stacked
    arrays the coordinate-encoded fields built on the target grid."""
    kw = PERIODS[periods]
    both_init(6, 6, 6, **kw)
    T, Tt = _encoded((6, 6, 6))
    Vx, Vxt = _encoded((7, 6, 6))
    path = gen_path(tmp_path, fmt)
    (it.save_checkpoint if fmt == "flat" else it.save_checkpoint_sharded)(
        path, T=Tt, Vx=Vxt)
    want = {"T": np.asarray(igg.gather_interior(T)),
            "Vx": np.asarray(igg.gather_interior(Vx))}
    local = []
    for d, key in enumerate(("periodx", "periody", "periodz")):
        open_b = not kw.get(key, 0)
        size = 2 * 4 + (2 if open_b else 0)
        local.append((size - (2 if open_b else 0)) // target[d] + 2)
    both_init(*local, dimx=target[0], dimy=target[1], dimz=target[2], **kw)
    out = it.load_checkpoint(path, redistribute=True)
    for name in ("T", "Vx"):
        np.testing.assert_array_equal(it.gather_interior(out[name]),
                                      want[name])
    exp_T, _ = _encoded(tuple(local))
    exp_V, _ = _encoded((local[0] + 1,) + tuple(local[1:]))
    np.testing.assert_array_equal(out["T"].numpy(), np.asarray(exp_T))
    np.testing.assert_array_equal(out["Vx"].numpy(), np.asarray(exp_V))
    it.update_halo(out["T"])
    both_finalize()


@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_redistribute_rejects_periodicity_and_domain(tmp_path, fmt):
    both_init(6, 6, 6, periodx=1)
    path = gen_path(tmp_path, fmt)
    save("port", fmt, path, {"T": state("float64")["T"]})
    it.finalize_global_grid()
    it.init_global_grid(10, 6, 6, dimx=1, dimy=1, dimz=1, device="cpu",
                        quiet=True)
    with pytest.raises(it.GridError, match="periodicity"):
        it.load_checkpoint(path, redistribute=True)
    it.finalize_global_grid()
    it.init_global_grid(7, 7, 7, dimx=1, dimy=1, dimz=1, periodx=1,
                        device="cpu", quiet=True)
    with pytest.raises(it.GridError, match="physical domain"):
        it.load_checkpoint(path, redistribute=True)
    both_finalize()


def test_misuse(tmp_path):
    it.init_global_grid(6, 6, 6, nprocs=8, device="cpu", quiet=True)
    T = it.zeros((6, 6, 6))
    for save_fn in (it.save_checkpoint, it.save_checkpoint_sharded):
        with pytest.raises(it.GridError, match="no fields"):
            save_fn(tmp_path / "ck")
        with pytest.raises(it.GridError, match="reserved"):
            save_fn(tmp_path / "ck", **{"__igg_meta__": T})
    with pytest.raises(it.GridError, match="DIRECTORY"):
        it.save_checkpoint_sharded(tmp_path / "gen.npz", T=T)
    it.finalize_global_grid()
    with pytest.raises(it.GridError, match="init_global_grid"):
        it.save_checkpoint(tmp_path / "ck", T=T)


def test_bfloat16_and_path_and_names(tmp_path):
    """A suffix-less path round-trips to the exact path given, a field
    named "file" does not collide, bfloat16 comes back as bfloat16; igg
    reads the same file."""
    both_init(6, 6, 6, periodx=1)
    T = it.full((6, 6, 6), 3.5, dtype=torch.bfloat16)
    it.save_checkpoint(tmp_path / "ck", T=T, file=T)
    assert (tmp_path / "ck").is_file()
    out = it.load_checkpoint(tmp_path / "ck")
    assert out["T"].dtype == torch.bfloat16
    same(out["T"], T)
    same(out["file"], T)
    got = igg.load_checkpoint(tmp_path / "ck")
    assert got["T"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["file"], np.float32), 3.5)
    both_finalize()


def _sharded(tmp_path, periods=None, name="gen"):
    """A port generation of igg's (2,2,2) TestSharded state; returns the
    stacked arrays."""
    both_init(6, 6, 6, **(periods or {}))
    T, Tt = _encoded((6, 6, 6))
    Vx, Vxt = _encoded((7, 6, 6))
    it.save_checkpoint_sharded(tmp_path / name, T=Tt, Vx=Vxt)
    return {"T": np.asarray(T), "Vx": np.asarray(Vx)}


def test_sharded_no_process_materializes_the_global_array(tmp_path,
                                                          monkeypatch):
    """The O(block) contract: the sharded save and both restores (1:1 and
    elastic) never fetch the global array, no fetch is larger than one
    block, and loads hold at most one target block in host memory."""
    import importlib

    tgather = importlib.import_module("igg_torch.gather")
    want = _sharded(tmp_path, dict(periodx=1))

    def boom(*a, **k):
        raise AssertionError("global-array path used by the sharded layer")

    fetched = []
    real = tgather._slabbed_get

    def spy(A, limit):
        fetched.append(A.numel())
        return real(A, limit)

    monkeypatch.setattr(tgather, "_fetch_global", boom)
    monkeypatch.setattr(ck, "_fetch_global", boom)
    monkeypatch.setattr(ck, "_slabbed_get", spy)
    state = it.load_checkpoint(tmp_path / "gen")
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k])
    it.save_checkpoint_sharded(tmp_path / "gen2", **state)
    assert it.verify_checkpoint(tmp_path / "gen2")
    assert fetched and max(fetched) <= 7 * 6 * 6
    both_init(10, 6, 4, dimx=1, dimy=2, dimz=4, periodx=1)
    assembled = []
    real_asm = ck._assemble_block

    def spy_asm(*a, **k):
        out = real_asm(*a, **k)
        assembled.append(out.size)
        return out

    monkeypatch.setattr(ck, "_assemble_block", spy_asm)
    it.load_checkpoint(tmp_path / "gen", redistribute=True)
    assert assembled and max(assembled) <= 11 * 6 * 4
    both_finalize()


def test_uncommitted_and_staging_generations_invalid(tmp_path):
    from igg_torch.checkpoint import list_generations

    _sharded(tmp_path)
    (tmp_path / "gen").rename(tmp_path / "ckpt_000000005")
    assert [s for s, _ in list_generations(tmp_path)] == [5]
    shutil.copytree(tmp_path / "ckpt_000000005", tmp_path / "ckpt_000000006")
    (tmp_path / "ckpt_000000006" / "manifest.json").unlink()
    assert not it.verify_checkpoint(tmp_path / "ckpt_000000006")
    with pytest.raises(it.GridError, match="uncommitted"):
        it.load_checkpoint(tmp_path / "ckpt_000000006")
    assert it.latest_checkpoint(tmp_path) == tmp_path / "ckpt_000000005"
    chaos.corrupt_checkpoint(tmp_path / "ckpt_000000005",
                             "preempt_mid_write")
    assert [s for s, _ in list_generations(tmp_path)] == [6]
    assert it.latest_checkpoint(tmp_path) is None
    both_finalize()


@pytest.mark.parametrize("mode,match", [
    ("bitflip", "CRC32 mismatch"), ("truncate", "cannot read shard"),
    ("missing_shard", "cannot read shard|has no shard")])
def test_corrupt_and_missing_shards_detected(tmp_path, mode, match):
    _sharded(tmp_path)
    ok = tmp_path / "gen"
    assert it.verify_checkpoint(ok, check_finite=True)
    bad = tmp_path / f"bad_{mode}"
    shutil.copytree(ok, bad)
    chaos.corrupt_checkpoint(bad, mode, shard=3)
    assert not it.verify_checkpoint(bad)
    assert not igg.verify_checkpoint(bad)
    with pytest.raises(it.GridError, match=match):
        it.load_checkpoint(bad)
    both_finalize()


def test_raw_byte_flip_in_a_shard_refused(tmp_path):
    """One byte of a shard's array data flipped in place (the zip's own
    CRC left stale, as the card phase does it): both packages refuse the
    generation and the scan skips it for the older one."""
    _sharded(tmp_path, name="ckpt_000000001")
    shutil.copytree(tmp_path / "ckpt_000000001", tmp_path / "ckpt_000000002")
    shard = tmp_path / "ckpt_000000002" / "shard_00002.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 3] ^= 0x10
    shard.write_bytes(bytes(data))
    assert not it.verify_checkpoint(tmp_path / "ckpt_000000002")
    assert not igg.verify_checkpoint(tmp_path / "ckpt_000000002")
    with pytest.raises(it.GridError, match="CRC32 mismatch"):
        it.load_checkpoint(tmp_path / "ckpt_000000002")
    assert it.latest_checkpoint(tmp_path) == tmp_path / "ckpt_000000001"
    both_finalize()


def test_shard_swap_caught_by_summary_crc(tmp_path):
    _sharded(tmp_path)
    gen = tmp_path / "gen"
    a, b = gen / "shard_00000.npz", gen / "shard_00007.npz"
    tmp = gen / "swap"
    os.replace(a, tmp), os.replace(b, a), os.replace(tmp, b)
    assert not it.verify_checkpoint(gen)
    with pytest.raises(it.GridError, match="summary CRC32"):
        it.load_checkpoint(gen)
    both_finalize()


def test_verify_distributed_single_process_equals_plain(tmp_path):
    _sharded(tmp_path)
    assert it.verify_checkpoint_distributed(tmp_path / "gen",
                                            check_finite=True)
    assert it.latest_checkpoint(tmp_path, prefix="gen", distributed=True) \
        is None   # "gen" is not a "<prefix>_<step>" name
    chaos.corrupt_checkpoint(tmp_path / "gen", "bitflip")
    assert not it.verify_checkpoint_distributed(tmp_path / "gen")
    assert it.verify_checkpoint_distributed(tmp_path / "gen") == \
        it.verify_checkpoint(tmp_path / "gen")
    both_finalize()


def test_non_finite_refused_by_check_finite(tmp_path):
    both_init(6, 6, 6)
    arrays = state("bfloat16", seed=22)
    arrays["T"][3, 4, 5] = np.nan
    for fmt in ("flat", "sharded"):
        path = gen_path(tmp_path, fmt)
        save("port", fmt, path, arrays)
        assert it.verify_checkpoint(path)
        assert not it.verify_checkpoint(path, check_finite=True)
        assert not igg.verify_checkpoint(path, check_finite=True)
    both_finalize()


def test_generation_overwrite_is_atomic_replace(tmp_path):
    _, T = _encoded_grid()
    it.save_checkpoint_sharded(tmp_path / "gen", T=T, Extra=T)
    it.save_checkpoint_sharded(tmp_path / "gen", T=T)
    assert set(it.load_checkpoint(tmp_path / "gen")) == {"T"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["gen"]
    both_finalize()


def _encoded_grid():
    both_init(6, 6, 6, periodx=1)
    return _encoded((6, 6, 6))


def test_dead_attempt_leftovers_cleared_and_hellos_answered(tmp_path):
    """A dead attempt's staging dir at the name (stale shard, hello, ack,
    token) is cleared before the save writes; the committed generation
    holds only shards and the manifest; process 0's handshake side answers
    a peer's hello with the nonce and this attempt's token."""
    _, T = _encoded_grid()
    staging = tmp_path / "ckpt_000000005.tmp"
    staging.mkdir()
    (staging / "hello_00001").write_text("stalenonce")
    (staging / "ack_00001").write_text("stalenonce\nstaletoken")
    (staging / "attempt.token").write_text("staletoken")
    (staging / "shard_00009.npz").write_bytes(b"stale")
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000005", T=T)
    names = {p.name for p in (tmp_path / "ckpt_000000005").iterdir()}
    assert names == {"manifest.json"} | {f"shard_{r:05d}.npz"
                                         for r in range(8)}
    assert not staging.exists()
    hs = tmp_path / "hs"
    hs.mkdir()
    (hs / "hello_00003").write_text("nonce3")
    ck._ack_hellos(hs, "tok")
    assert (hs / "ack_00003").read_text() == "nonce3\ntok"
    both_finalize()


def test_same_step_flat_and_sharded_both_candidates(tmp_path):
    _, T = _encoded_grid()
    it.save_checkpoint_sharded(tmp_path / "ckpt_000000007", T=T)
    it.save_checkpoint(tmp_path / "ckpt_000000007.npz", T=T)
    chaos.corrupt_checkpoint(tmp_path / "ckpt_000000007.npz", "truncate")
    found = it.latest_checkpoint(tmp_path)
    assert found is not None and found.is_dir()
    both_finalize()


def test_latest_and_prune_generations(tmp_path):
    """The generation scan: newest valid first, `max_step`, a longer
    prefix never matching; the ring prune keeps the newest `ring` and the
    newest at or below `good_until` (igg's rule, same survivors)."""
    from igg import checkpoint as ick

    _, T = _encoded_grid()
    for s in (1, 2, 3, 4, 5):
        it.save_checkpoint_sharded(tmp_path / f"ckpt_{s:09d}", T=T)
    it.save_checkpoint(tmp_path / "ckpt_b_000000009.npz", T=T)
    assert it.latest_checkpoint(tmp_path).name == "ckpt_000000005"
    assert it.latest_checkpoint(tmp_path, max_step=3).name == \
        "ckpt_000000003"
    assert ck.checkpoint_step(tmp_path / "ckpt_000000004") == 4
    assert ck.checkpoint_step(tmp_path / "ckpt_000000004.tmp") is None
    twin = tmp_path.parent / (tmp_path.name + "_igg")
    shutil.copytree(tmp_path, twin)
    ck.prune_generations(tmp_path, "ckpt", ring=2, good_until=2)
    ick.prune_generations(twin, "ckpt", ring=2, good_until=2)
    assert [s for s, _ in ck.list_generations(tmp_path)] == [2, 4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(p.name for p in twin.iterdir())
    both_finalize()


def test_stale_staging_swept(tmp_path):
    """Old `.npz.tmp` files and staging dirs of this module's shape are
    swept by the next save; young ones and foreign `.tmp` entries stay."""
    _, T = _encoded_grid()
    old = time.time() - 2 * ck._STALE_TMP_AGE_S
    (tmp_path / "a.npz.tmp").write_bytes(b"x")
    (tmp_path / "young.npz.tmp").write_bytes(b"x")
    (tmp_path / "ckpt_1.tmp").mkdir()
    (tmp_path / "ckpt_1.tmp" / "shard_00000.npz").write_bytes(b"x")
    (tmp_path / "foreign.tmp").mkdir()
    (tmp_path / "foreign.tmp" / "notes.txt").write_text("mine")
    for p in ("a.npz.tmp", "ckpt_1.tmp", "foreign.tmp"):
        os.utime(tmp_path / p, (old, old))
    ck._warned_stale_tmp = False
    with pytest.warns(UserWarning, match="stale"):
        it.save_checkpoint(tmp_path / "ck.npz", T=T)
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["ck.npz", "foreign.tmp", "young.npz.tmp"]
    both_finalize()


def test_rank4_roundtrip_and_redistribute(tmp_path):
    both_init(6, 6, 6, periodx=1)
    U, Ut = _encoded((6, 6, 6, 2))
    for fmt in ("flat", "sharded"):
        path = gen_path(tmp_path, fmt, "r4")
        (it.save_checkpoint if fmt == "flat" else it.save_checkpoint_sharded)(
            path, U=Ut)
        same(it.load_checkpoint(path)["U"], Ut)
    want = np.asarray(igg.gather_interior(U))
    both_init(10, 6, 6, dimx=1, dimy=2, dimz=2, periodx=1)
    for fmt in ("flat", "sharded"):
        out = it.load_checkpoint(gen_path(tmp_path, fmt, "r4"),
                                 redistribute=True)["U"]
        np.testing.assert_array_equal(it.gather_interior(out), want)
    both_finalize()


# -- snapshots --------------------------------------------------------------

@pytest.mark.parametrize("change", ["update_halo", "step", "add_"])
@pytest.mark.parametrize("fmt", ["flat", "sharded"])
def test_save_holds_the_state_of_the_call(tmp_path, fmt, change):
    """After a save the fields change in place (a halo update, a diffusion
    step, `T.add_(1)`); the generation still holds the state of the
    call."""
    it.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, device="cpu",
                        quiet=True)
    p = t3.Params()
    T, Cp = t3.init_fields(p)
    T[6, 3, 3] += 1.0     # a cell block (1,0,0)'s halo copies, out of date
    before = T.clone()
    path = gen_path(tmp_path, fmt)
    (it.save_checkpoint if fmt == "flat" else it.save_checkpoint_sharded)(
        path, T=T, Cp=Cp)
    if change == "update_halo":
        it.update_halo(T)
    elif change == "step":
        T.copy_(t3.make_multi_step(2, p)(T, Cp))
    else:
        T.add_(1)
    assert not torch.equal(T, before)
    np.testing.assert_array_equal(it.load_checkpoint(path)["T"].numpy(),
                                  before.numpy())


# -- telemetry ----------------------------------------------------------------

def test_telemetry_names_and_labels_match_igg(tmp_path):
    """Both saves emit igg's counter, histogram and record, with igg's
    names, labels and fields (the port's record adds the split of the
    save's seconds)."""
    both_init(6, 6, 6)
    arrays = state("float32", seed=23)
    seen = {"igg": [], "port": []}
    igg_tel.reset_metrics()
    tel.reset_metrics()
    igg_tel.subscribe(seen["igg"].append)
    tel.subscribe(seen["port"].append)
    try:
        for writer in ("igg", "port"):
            save(writer, "flat", tmp_path / f"{writer}.npz", arrays)
            save(writer, "sharded", tmp_path / writer, arrays)
    finally:
        igg_tel.unsubscribe(seen["igg"].append)
        tel.unsubscribe(seen["port"].append)
    si, st = igg_tel.snapshot(), tel.snapshot()
    keys = sorted(k for k in si if "checkpoint" in k)
    assert keys == sorted(k for k in st if "checkpoint" in k)
    assert keys
    assert si["igg_checkpoint_bytes_total"]["value"] == \
        st["igg_checkpoint_bytes_total"]["value"]
    recs = {w: [r for r in seen[w] if r.kind == "checkpoint_write"]
            for w in seen}
    split = {"fetch_seconds", "stamp_seconds", "write_seconds"}
    assert [sorted(r.payload) for r in recs["igg"]] == \
        [sorted(set(r.payload) - split) for r in recs["port"]]
    for r in recs["port"]:
        # The port's record adds the save's seconds by part.
        assert split <= set(r.payload)
        assert sum(r.payload[k] for k in split) <= r.payload["seconds"] + 1e-5
    assert [(r.payload["format"], r.payload["bytes"]) for r in recs["igg"]] \
        == [(r.payload["format"], r.payload["bytes"]) for r in recs["port"]]
    both_finalize()
