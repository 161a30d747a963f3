"""``run``: the entry point of the experiment API."""
from __future__ import annotations

from typing import Union

from .planes import LivePlane  # noqa: F401  (registers the plane)
from .registry import PLANES
from .report import RunReport
from .spec import ExperimentSpec, SpecError


def get_plane(plane: Union[str, object] = "sim"):
    """Resolve a plane argument: a registered name (``"live"``, constructed
    with defaults) or an already-built plane instance.  ``"sim"``, the JAX
    package's default, raises naming its ROADMAP item."""
    if isinstance(plane, str):
        if plane == "sim":
            raise SpecError("plane", "the sim plane is not ported yet (ROADMAP "
                                     "queue 1, item 9); use plane='live'")
        return PLANES.get(plane)()
    if hasattr(plane, "run") and hasattr(plane, "name"):
        return plane
    raise SpecError("plane", f"expected a plane name {PLANES.names()} or a "
                             f"plane instance, got {type(plane).__name__}")


def run(spec: ExperimentSpec, plane: Union[str, object] = "sim", *,
        arrivals=None, controller=None, store=None,
        trace: bool = False) -> RunReport:
    """Execute one :class:`ExperimentSpec` on the chosen plane.

    ``arrivals=`` pins a pre-generated trace (identical-trace comparisons
    across policies/planes); ``controller=`` injects an existing stateful
    autoscale controller instead of building one from ``spec.autoscale``.
    The signature is the JAX package's ``repro.api.run``: its default plane
    is the sim plane, and ``store=`` (the results store) and ``trace=True``
    (the flight recorder) are not ported yet, so each raises naming its
    ROADMAP item rather than running something else.
    """
    if not isinstance(spec, ExperimentSpec):
        raise SpecError("spec",
                        f"expected an ExperimentSpec, got "
                        f"{type(spec).__name__} (build one, or "
                        f"ExperimentSpec.from_dict(...) it)")
    if store is not None:
        raise SpecError("store", "the results store (api/results.py) is not "
                                 "ported yet (ROADMAP queue 1, item 14)")
    p = get_plane(plane)
    return p.run(spec, arrivals=arrivals, controller=controller,
                 **({"trace": True} if trace else {}))
