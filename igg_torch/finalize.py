"""Grid finalization: the port's `finalize_global_grid`."""

from __future__ import annotations

from . import shared


def finalize_global_grid() -> None:
    """Finalize the global grid: the ambient handle is cleared (inside
    `shared.thread_grid_scope`, the thread's own), so every grid function
    raises until the next `init_global_grid`, and the tier ladder's state
    (verifications, active tiers, events) is reset for every thread, as
    in igg; the halo byte accounting's cache, kept per grid epoch, is
    emptied."""
    shared.check_initialized()
    from . import degrade, halo, tools
    tools.reset_timer()
    degrade.reset()
    halo._PLANE_BYTES.clear()
    shared.set_global_grid(None)
