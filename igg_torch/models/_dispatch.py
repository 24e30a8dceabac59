"""Route resolution and the tier ladder shared by the models
(`igg/models/_dispatch.py`).

:func:`auto_dispatch` builds a family's :class:`igg_torch.degrade.Ladder`:
one tier per kernel route, then the plain truth tier.  Tier names follow
igg's `<family>.<route>`:

| igg | port |
| --- | --- |
| `<family>.trapezoid`, `.chunk`, `.banded` | the same name, the same route |
| `<family>.mosaic` (the fused kernel) | `<family>.cuda` |
| `<family>.xla` (the truth rung) | `<family>.plain` |

The route rules themselves are each family's (its `_kernel_path`, the
banded tier's `band_config` here and the chunk fits of `igg_torch.ops`):
a family's `plan` names the one route that serves a call, and each tier
admits the calls its route is named for.  So the ladder changes no route
and no output, and `verify=` adds the check of the route against the
plain version.  `resolve_band` and `band_config` are the banded tier's
rules, `resolve_chunk_K` the chunk route's depth, and `apply_tuned` the
factories' `tune=` (igg's precedence rules for an autotuner's cached
winner, :mod:`igg_torch.autotune`).
"""

from __future__ import annotations

from .. import shared
from ..shared import GridError


def resolve_band(K, band, from_cache: bool, supported, fit, bands=(8, 16)):
    """The banded tier's `(K, B)` (igg's `resolve_band`): an explicit
    `(K, band)` pair serves iff `supported(K, B)` admits it; a caller's pin
    refuses (None) on a mismatch, while a cache-sourced one (`from_cache`)
    falls back to the fit.  Without K, `fit(bands)` searches the band depths
    `band` (when given) or `bands`.  Returns `(K, B)` or None."""
    cand = (int(band),) if band is not None else tuple(bands)
    if K is not None:
        for b in cand:
            if supported(int(K), b):
                return int(K), b
        if not from_cache:
            return None
        return fit(tuple(bands))
    got = fit(cand)
    if got is None and band is not None and from_cache:
        got = fit(tuple(bands))
    return got


def resolve_chunk_K(K, K_from_cache: bool, supported, fit) -> int:
    """The chunk route's depth (igg's `resolve_chunk_K`): an explicit K
    serves iff `supported(K)` admits it (a caller's pin gives 0 on a
    mismatch, a cache-sourced one falls back to the fit); without K,
    `fit()`, the largest admitted depth (0 where none is)."""
    if K is not None:
        if supported(K):
            return K
        if not K_from_cache:
            return 0
    return fit()


def band_config(banded, K, band, n_inner: int, *, resident, supported, fit,
                requirement: str, from_cache: bool = False):
    """The `(K, B)` a model's call runs on the banded tier, or None where
    another route serves: ``False`` never takes the tier; ``"auto"`` takes
    it only where `resident()` (the K-step loop or the chunk route serves
    the call) is false and some `(K, B)` admits; ``True`` takes it or
    raises a GridError that starts with `requirement`; ``"cached"`` (an
    autotuner's banded winner, :func:`apply_tuned`) takes it wherever some
    `(K, B)` admits.  `supported(K, B)` and `fit(bands)` are the family's
    gate and fit over the `n_inner - 1` steps after the warm-up step;
    `from_cache` marks `K` and `band` as the cache's (:func:`resolve_band`)."""
    if banded is False or (banded == "auto" and resident()):
        return None
    kb = (resolve_band(K, band, from_cache, supported, fit) if n_inner >= 3
          else None)
    if kb is None and banded is True:
        raise GridError(f"{requirement}; none admits n_inner={n_inner}, "
                        f"K={K}, band={band}")
    return kb


def required_routes(use_kernels, banded="auto", chunk="auto",
                    chunk_route: str = "chunk") -> tuple:
    """The routes a factory's knobs require: "cuda" with
    `use_kernels=True`, "banded" with `banded=True`, `chunk_route` with
    `chunk=True` (`trapezoid=True` for Stokes and HM3D)."""
    return tuple(r for r, knob in (("cuda", use_kernels), ("banded", banded),
                                   (chunk_route, chunk)) if knob is True)


def apply_tuned(family, tune, *, n_inner, K, chunk_knob, use_kernels,
                band=None, banded_knob="auto", params=None):
    """A factory's cached-winner application (igg's `apply_tuned`, one set
    of precedence rules for every family):

    - a cached winner's `K` fills an unset caller `K` and is marked
      cache-sourced, so the chunk route's depth falls back to the fit where
      that K does not admit this factory's `n_inner` (the cache key has no
      `n_inner`; only a caller's pin refuses); its `band` fills an unset
      `band` the same way;
    - a `<family>.cuda` or `<family>.banded` winner turns `chunk_knob`
      "auto" off;
    - a `<family>.banded` winner turns `banded_knob` "auto" into "cached"
      (:func:`band_config`: the tier serves without the resident routes'
      refusal, and does not raise where no `(K, B)` admits); a
      `<family>.cuda` winner turns it off;
    - a `<family>.plain` or `<family>.overlap` winner pins `use_kernels`
      off only where the caller left every knob at "auto".

    Returns `(K, K_from_cache, band, band_from_cache, chunk_knob,
    banded_knob, use_kernels, tuned)`; `tuned` is the winner (or None),
    whose `overlap` the factory gives :func:`igg_torch.overlap.
    resolve_overlap`."""
    from .. import autotune

    tuned = autotune.applied(family, tune, n_inner=n_inner, params=params)
    K_from_cache = False
    if K is None and tuned and tuned.get("K"):
        K, K_from_cache = int(tuned["K"]), True
    band_from_cache = False
    if band is None and tuned and tuned.get("band"):
        band, band_from_cache = int(tuned["band"]), True
    winner = tuned.get("tier") if tuned else None
    if chunk_knob == "auto" and winner in (f"{family}.cuda",
                                           f"{family}.banded"):
        chunk_knob = False
    if banded_knob == "auto":
        if winner == f"{family}.banded":
            banded_knob = "cached"
        elif winner == f"{family}.cuda":
            banded_knob = False
    if use_kernels == "auto" and chunk_knob == "auto" and \
            banded_knob == "auto" and winner in (f"{family}.plain",
                                                 f"{family}.overlap"):
        use_kernels = False
    return (K, K_from_cache, band, band_from_cache, chunk_knob,
            banded_knob, use_kernels, tuned)


def auto_dispatch(*, family: str, plan, routes, plain, required=(),
                  verify=None, overlap=None):
    """The dispatcher of a model factory: a :class:`igg_torch.degrade.
    Ladder` for `family` whose tiers are `routes` (`{route: run}`, in
    ladder order; tier `<family>.<route>`), then, where `overlap` is given,
    `<family>.overlap` serving `overlap(*args)` (the overlapped plain
    composition, :func:`igg_torch.overlap.hide_communication`) on the
    calls the plan gives to the plain composition, then `<family>.plain`,
    the truth tier serving `plain(*args)`.

    `plan(*args)` names the route of a call, `(route, cfg)`: "plain" or a
    key of `routes`, and the configuration `run(cfg, *args)` takes; it
    raises where the family's route rules raise.  It reads only the
    arguments' shapes, dtypes and devices and the grid, so its verdict is
    kept per argument signature and grid epoch.  The tiers named in
    `required` raise when refused (`use_kernels=True` names "cuda",
    `banded=True` "banded").  `verify` is the ladder's (None:
    `IGG_VERIFY_KERNELS` decides).  The returned callable exposes the
    ladder as `.ladder`."""
    from ..degrade import Admission, Ladder, Tier

    verdicts = {}

    def planned(args):
        key = (shared.grid_epoch(),) + tuple(
            (tuple(a.shape), a.dtype, a.device) for a in args)
        got = verdicts.get(key)
        if got is None:
            got = verdicts[key] = plan(*args)
        return got

    def tier(rung, route, run, serves=None):
        def admit(args):
            got = planned(args)[0]
            return (Admission.yes() if got == (serves or route) else
                    Admission.no(f"the route rules give {family}.{got}"))

        def build():
            return lambda *args: run(planned(args)[1], *args)

        return Tier(name=f"{family}.{route}", rung=rung, build=build,
                    admit=admit, required=route in required)

    tiers = [tier(i, route, run)
             for i, (route, run) in enumerate(routes.items())]
    if overlap is not None:
        tiers.append(tier(len(tiers), "overlap",
                          lambda _cfg, *args: overlap(*args), serves="plain"))
    tiers.append(Tier(name=f"{family}.plain", rung=len(tiers),
                      build=lambda: plain, truth=True))
    ladder = Ladder(family, tiers, verify=verify)

    def dispatch(*args):
        return ladder.dispatch(*args)

    dispatch.ladder = ladder
    return dispatch
