"""The ``mesh=`` argument of the parallel engines, which the port refuses."""

from __future__ import annotations


def refuse_mesh(engine: str, mesh) -> None:
    """Raise unless ``mesh`` is None: on one card the engines fold the JAX
    package's mesh axis into their batch, and spreading the work over
    several cards is ROADMAP queue 1 item 7."""
    if mesh is not None:
        raise NotImplementedError(
            f"{engine}(mesh=...) spreads the work over several chips, which the port does not do yet "
            "(ROADMAP queue 1, item 7: the multi-card engines); on one card leave mesh=None")
