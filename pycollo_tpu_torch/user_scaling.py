"""User-facing scaling containers (API parity).

The reference exposes ``PhaseScaling`` / ``EndpointScaling`` user objects
for ``scaling_method = "user"`` (``pycollo/scaling.py`` user classes), an
option that is enumerated-but-unsupported in both the reference's
``SCALING_METHODS`` registry and ours (``pycollo_tpu_torch/settings.py``).  The
containers exist so problem definitions that set them still construct; a
solve with ``scaling_method="user"`` raises through the options registry.
"""

from __future__ import annotations


class PhaseScaling:
    """Per-phase user scaling specification."""

    def __init__(self, phase=None, *, time=None, state_variables=None,
                 control_variables=None, integral_variables=None):
        self.phase = phase
        self.time = time
        self.state_variables = state_variables
        self.control_variables = control_variables
        self.integral_variables = integral_variables


class EndpointScaling:
    """Problem-level user scaling specification."""

    def __init__(self, ocp=None, *, parameter_variables=None,
                 endpoint_constraints=None):
        self.ocp = ocp
        self.parameter_variables = parameter_variables
        self.endpoint_constraints = endpoint_constraints
