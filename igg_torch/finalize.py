"""Grid finalization: the port's `finalize_global_grid`."""

from __future__ import annotations

from . import shared


def finalize_global_grid() -> None:
    """Finalize the global grid: the ambient handle is cleared, so every
    grid function raises until the next `init_global_grid`."""
    shared.check_initialized()
    from . import tools
    tools.reset_timer()
    shared.set_global_grid(None)
