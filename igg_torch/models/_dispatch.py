"""Route resolution shared by the models (`igg/models/_dispatch.py`).

Only the banded tier's rules are ported: `resolve_band` and the
`banded="auto"|True|False` decision of the diffusion and HM3D models; the
tier ladder, its `verify=`/`tune=` arguments and the autotuner's cache are
later work.
"""

from __future__ import annotations

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
