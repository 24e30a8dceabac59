"""Grid finalization: the port's `finalize_global_grid`."""

from __future__ import annotations

from . import shared


def finalize_global_grid() -> None:
    """Finalize the global grid: the ambient handle is cleared, so every
    grid function raises until the next `init_global_grid`, and the tier
    ladder's state (verifications, active tiers, events) is reset, as in
    igg."""
    shared.check_initialized()
    from . import degrade, tools
    tools.reset_timer()
    degrade.reset()
    shared.set_global_grid(None)
