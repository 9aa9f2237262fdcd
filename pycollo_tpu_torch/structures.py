"""Structures passed to user endpoint functions.

Every field is component-first: the leading axis indexes the variables and
any further axes are instance axes (``(ny, B)`` for a batch of B, ``(ny,)``
for one instance).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple


class PhaseEndpoints(NamedTuple):
    """Endpoint values of one phase: y(t0), y(tF), q, t0, tF."""

    y0: Any   # (ny, *batch)
    yF: Any   # (ny, *batch)
    q: Any    # (nq, *batch)
    t0: Any   # (*batch)
    tF: Any   # (*batch)


class Endpoints(NamedTuple):
    """Arguments to objective / endpoint-constraint functions.

    ``phase`` is a tuple of :class:`PhaseEndpoints` (one per phase) and
    ``s`` the problem parameter vector.  Mirrors the reference's endpoint
    variable set ``x_b = (y_t0, y_tF, q, t0, tF, s)``
    (``pycollo/backend.py:632-704``).
    """

    phase: Tuple[PhaseEndpoints, ...]
    s: Any    # (ns, *batch)
