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
rules; the autotuner's cache and `tune=` are later work.
"""

from __future__ import annotations

from .. import shared
from ..shared import GridError


def resolve_band(K, band, from_cache: bool, supported, fit, bands=(8, 16)):
    """The banded tier's `(K, B)` (igg's `resolve_band`): an explicit
    `(K, band)` pair serves iff `supported(K, B)` admits it; a caller's pin
    refuses (None) on a mismatch, while a cache-sourced one (`from_cache`)
    falls back to the fit.  Without K, `fit(bands)` searches the band depths
    `band` (when given) or `bands`.  The port has no perf cache yet, so
    its callers pass `from_cache=False`.  Returns `(K, B)` or None."""
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


def band_config(banded, K, band, n_inner: int, *, resident, supported, fit,
                requirement: str):
    """The `(K, B)` a model's call runs on the banded tier, or None where
    another route serves: ``False`` never takes the tier; ``"auto"`` takes
    it only where `resident()` (the K-step loop or the chunk route serves
    the call) is false and some `(K, B)` admits; ``True`` takes it or
    raises a GridError that starts with `requirement`.  `supported(K, B)`
    and `fit(bands)` are the family's gate and fit over the `n_inner - 1`
    steps after the warm-up step."""
    if banded is False or (banded == "auto" and resident()):
        return None
    kb = resolve_band(K, band, False, supported, fit) if n_inner >= 3 else None
    if kb is None and banded is True:
        raise GridError(f"{requirement}; none admits n_inner={n_inner}, "
                        f"K={K}, band={band}")
    return kb


def required_routes(use_kernels, banded="auto", chunk="auto") -> tuple:
    """The routes a factory's knobs require: "cuda" with
    `use_kernels=True`, "banded" with `banded=True`, "chunk" with
    `chunk=True`."""
    return tuple(r for r, knob in (("cuda", use_kernels), ("banded", banded),
                                   ("chunk", chunk)) if knob is True)


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
