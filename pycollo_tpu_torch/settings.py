"""Validated settings object for the optimal control problem.

Capability parity with the reference ``Settings``
(``pycollo/settings.py:1-466``): typed/validated properties with option
registries and range checks, covering backend selection, quadrature, solver
tolerances, mesh iteration limits, scaling, and bounds behavior.  Options
that exist in the reference but have no meaning for the on-device solver (e.g. IPOPT's
``linear_solver = mumps``) are replaced by the equivalent choices for the
on-device solver.
"""

from __future__ import annotations

from . import quadrature as quad
from .utils import Options

BACKENDS = Options(("torch", "casadi", "pycollo", "hsad", "sympy"),
                   default="torch",
                   unsupported=("casadi", "pycollo", "hsad", "sympy"))

COLLOCATION_MATRIX_FORMS = Options(("differential", "integral"),
                                   default="integral",
                                   unsupported=("differential",))

#: On-device NLP solver choices. ``ipm`` is the native primal-dual
#: interior-point method (replaces IPOPT, ``pycollo/settings.py:42-52``).
NLP_SOLVERS = Options(("ipm", "ipopt", "snopt", "worhp", "bonmin", "couenne",
                       "knitro"),
                      default="ipm",
                      unsupported=("ipopt", "snopt", "worhp", "bonmin",
                                   "couenne", "knitro"))

#: KKT linear solver choices (replaces IPOPT's mumps/ma57 registry,
#: ``pycollo/settings.py:54-62``). ``condensed-cholesky`` = dense
#: condensed-space Schur-complement solve; ``block-banded`` = structured
#: factorization exploiting the collocation banding.
LINEAR_SOLVERS = Options(("condensed-cholesky", "block-banded", "mumps",
                          "ma57"),
                         default="condensed-cholesky",
                         unsupported=("mumps", "ma57"))

SCALING_METHODS = Options(("bounds", "guess", "user", "none"),
                          default="bounds", unsupported=("guess", "user"))

MESH_REFINEMENT_ALGORITHMS = Options(("patterson-rao",),
                                     default="patterson-rao")

_DTYPES = Options(("float64", "float32"), default="float64")


def _check_range(name, value, lo, hi):
    if not (lo <= value <= hi):
        raise ValueError(f"{name} must be in [{lo}, {hi}], got {value}.")
    return value


class Settings:
    """Settings for an :class:`OptimalControlProblem`.

    Defaults follow the reference where they are solver-independent:
    ``mesh_tolerance=1e-7`` (``pycollo/mesh_refinement.py:29``),
    ``max_mesh_iterations=10``, collocation points min/max 4/10 within the
    hard range 2..20 (``pycollo/quadrature.py:36-37``), scaling method
    ``bounds`` with EWMA update weight 0.8 (``pycollo/scaling.py:13-14``).
    The NLP tolerance default is 1e-8 (reference: 1e-10 for IPOPT,
    ``pycollo/settings.py:60``) reflecting the on-device f64 solver.
    """

    def __init__(self, optimal_control_problem=None):
        self.ocp = optimal_control_problem
        # Backend / transcription
        self._backend = BACKENDS.default
        self._collocation_matrix_form = COLLOCATION_MATRIX_FORMS.default
        self._quadrature_method = quad.QUADRATURES.default
        self._derivative_level = 2
        self._collocation_points_min = quad.DEFAULT_COLLOCATION_POINTS_MIN
        self._collocation_points_max = quad.DEFAULT_COLLOCATION_POINTS_MAX
        # NLP solver
        self._nlp_solver = NLP_SOLVERS.default
        self._linear_solver = LINEAR_SOLVERS.default
        self._nlp_tolerance = 1e-8
        self._max_nlp_iterations = 200
        #: gate the cross-mesh-iteration multiplier warm start (the
        #: reference's IPOPT ``warm_start_init_point`` pass-through,
        #: ``pycollo/backend.py:1703-1709``; reference default False).
        #: Default True here: the interpolated warm start carries a
        #: cold-retry fallback, so it is strictly beneficial.
        self.warm_start = True
        #: initial barrier parameter for the interior-point solver
        self.ipm_mu_init = 1e-1
        #: smallest barrier parameter (matches the reference's IPOPT
        #: override ``mu_min=1e-11``, ``pycollo/backend.py:1708``)
        self.ipm_mu_min = 1e-11
        #: globalization: "filter" (Wächter–Biegler, what IPOPT runs) or
        #: "merit" (l1 penalty Armijo)
        self.ipm_line_search = "filter"
        #: inertia correction: "speculative" (batched multi-level
        #: factorization) or "loop" (IPOPT-style sequential escalation)
        self.ipm_inertia = "speculative"
        # Mesh refinement
        self._mesh_refinement_algorithm = MESH_REFINEMENT_ALGORITHMS.default
        self._mesh_tolerance = 1e-7
        self._max_mesh_iterations = 10
        # Scaling
        self._scaling_method = SCALING_METHODS.default
        self.update_scaling = False
        self._scaling_weight = 0.8
        # Bounds behavior
        self.assume_inf_bounds = True
        self.numerical_inf = 1e19
        self.override_endpoint_bounds = True
        self.remove_constant_variables = True
        self.bound_clash_absolute_tolerance = 1e-6
        self.bound_clash_relative_tolerance = 1e-6
        # Display
        self.display_mesh_result_info = False
        self.display_mesh_result_graph = False
        self.console_out_progress = True
        # Debug
        self.check_nlp_functions = False
        # Numerics
        self._dtype = _DTYPES.default

    # ------------------------------------------------------------------
    @property
    def backend(self):
        return self._backend

    @backend.setter
    def backend(self, value):
        self._backend = BACKENDS.validate(value)

    @property
    def collocation_matrix_form(self):
        return self._collocation_matrix_form

    @collocation_matrix_form.setter
    def collocation_matrix_form(self, value):
        self._collocation_matrix_form = COLLOCATION_MATRIX_FORMS.validate(value)

    @property
    def quadrature_method(self):
        return self._quadrature_method

    @quadrature_method.setter
    def quadrature_method(self, value):
        self._quadrature_method = quad.QUADRATURES.validate(value)

    @property
    def derivative_level(self):
        return self._derivative_level

    @derivative_level.setter
    def derivative_level(self, value):
        value = int(value)
        if value not in (1, 2):
            raise ValueError("derivative_level must be 1 or 2.")
        self._derivative_level = value

    @property
    def collocation_points_min(self):
        return self._collocation_points_min

    @collocation_points_min.setter
    def collocation_points_min(self, value):
        value = int(value)
        _check_range("collocation_points_min", value,
                     quad.COLLOCATION_POINTS_MIN_BOUND,
                     quad.COLLOCATION_POINTS_MAX_BOUND)
        if value > self._collocation_points_max:
            raise ValueError("collocation_points_min must be at most "
                             "collocation_points_max.")
        self._collocation_points_min = value

    @property
    def collocation_points_max(self):
        return self._collocation_points_max

    @collocation_points_max.setter
    def collocation_points_max(self, value):
        value = int(value)
        _check_range("collocation_points_max", value,
                     quad.COLLOCATION_POINTS_MIN_BOUND,
                     quad.COLLOCATION_POINTS_MAX_BOUND)
        if value < self._collocation_points_min:
            raise ValueError("collocation_points_max must be at least "
                             "collocation_points_min.")
        self._collocation_points_max = value

    @property
    def nlp_solver(self):
        return self._nlp_solver

    @nlp_solver.setter
    def nlp_solver(self, value):
        self._nlp_solver = NLP_SOLVERS.validate(value)

    @property
    def linear_solver(self):
        return self._linear_solver

    @linear_solver.setter
    def linear_solver(self, value):
        self._linear_solver = LINEAR_SOLVERS.validate(value)

    @property
    def nlp_tolerance(self):
        return self._nlp_tolerance

    @nlp_tolerance.setter
    def nlp_tolerance(self, value):
        value = float(value)
        _check_range("nlp_tolerance", value, 0.0, 1.0)
        self._nlp_tolerance = value

    @property
    def max_nlp_iterations(self):
        return self._max_nlp_iterations

    @max_nlp_iterations.setter
    def max_nlp_iterations(self, value):
        value = int(value)
        _check_range("max_nlp_iterations", value, 1, 100000)
        self._max_nlp_iterations = value

    @property
    def mesh_refinement_algorithm(self):
        return self._mesh_refinement_algorithm

    @mesh_refinement_algorithm.setter
    def mesh_refinement_algorithm(self, value):
        self._mesh_refinement_algorithm = (
            MESH_REFINEMENT_ALGORITHMS.validate(value))

    @property
    def mesh_tolerance(self):
        return self._mesh_tolerance

    @mesh_tolerance.setter
    def mesh_tolerance(self, value):
        value = float(value)
        _check_range("mesh_tolerance", value, 0.0, 1.0)
        self._mesh_tolerance = value

    @property
    def max_mesh_iterations(self):
        return self._max_mesh_iterations

    @max_mesh_iterations.setter
    def max_mesh_iterations(self, value):
        value = int(value)
        _check_range("max_mesh_iterations", value, 1, 1000)
        self._max_mesh_iterations = value

    @property
    def scaling_method(self):
        return self._scaling_method

    @scaling_method.setter
    def scaling_method(self, value):
        if value is None:
            value = "none"
        self._scaling_method = SCALING_METHODS.validate(value)

    @property
    def scaling_weight(self):
        return self._scaling_weight

    @scaling_weight.setter
    def scaling_weight(self, value):
        value = float(value)
        _check_range("scaling_weight", value, 0.0, 1.0)
        self._scaling_weight = value

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, value):
        self._dtype = _DTYPES.validate(str(value))
