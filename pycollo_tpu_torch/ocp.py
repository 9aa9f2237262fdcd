"""Top-level :class:`OptimalControlProblem`.

Capability parity with ``pycollo/optimal_control_problem.py`` (572 LoC):
holds phases, parameter variables ``s``, endpoint constraints ``b``, the
objective ``J``, auxiliary data, bounds/guess/settings; ``initialise()``
compiles the problem (backend creation -> bounds -> scaling -> quadrature ->
initial mesh -> guess -> first iteration, ``optimal_control_problem.py:316-337``)
and ``solve()`` runs the ph-adaptive mesh-iteration loop
(``optimal_control_problem.py:387-443``).

Port differences: the "backend" is a batched PyTorch transcription
(:mod:`pycollo_tpu_torch.transcription`) solved by the batch-first
interior-point method (:mod:`pycollo_tpu_torch.solver.ipm`);
``solve_batched`` solves many perturbed instances of the same problem
simultaneously on one device — a capability the serial reference does not
have.  ``solve(device=...)`` runs every NLP solve of the refinement loop on
the given device.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Iterable, Optional

import numpy as np

from .bounds import EndpointBounds
from .guess import EndpointGuess
from .phase import NamedVarTuple, Phase, _as_var_tuple, _is_symbolic
from .settings import Settings
from .utils import console_out, format_time, solve_device


class _PhaseList(list):
    """List of phases with attribute access by phase name."""

    def __getattr__(self, name):
        for phase in self:
            if phase.name == name:
                return phase
        raise AttributeError(name)


class OptimalControlProblem:
    """A multiphase optimal control problem."""

    def __init__(self, name: Optional[str] = None, *,
                 parameter_variables=None, bounds=None, guess=None,
                 auxiliary_data=None, settings=None,
                 objective_function=None, endpoint_constraints=None):
        self.name = name
        self._phases = _PhaseList()
        self._parameter_variables = _as_var_tuple(parameter_variables)
        self.auxiliary_data = dict(auxiliary_data) if auxiliary_data else {}
        self.bounds = bounds if bounds is not None \
            else EndpointBounds(ocp=self)
        self.bounds.ocp = self
        self.guess = guess if guess is not None else EndpointGuess(ocp=self)
        self.guess.ocp = self
        self.settings = settings if settings is not None \
            else Settings(optimal_control_problem=self)
        self.settings.ocp = self
        self._objective_function = objective_function
        self._endpoint_constraints = \
            endpoint_constraints if endpoint_constraints is not None else ()
        self._num_endpoint_constraints = None
        self._initialised = False
        self._backend = None
        self._mesh_iterations = []
        self._solution = None

    # -- phases --------------------------------------------------------
    @property
    def phases(self) -> _PhaseList:
        return self._phases

    @property
    def number_phases(self) -> int:
        return len(self._phases)

    def add_phase(self, phase: Phase) -> Phase:
        """Register a phase with this problem."""
        phase.optimal_control_problem = self
        phase._phase_number = len(self._phases)
        if phase.name is None:
            phase.name = chr(ord("A") + phase._phase_number)
        self._phases.append(phase)
        return phase

    def add_phases(self, phases: Iterable[Phase]):
        return tuple(self.add_phase(p) for p in phases)

    def new_phase(self, name: Optional[str] = None, **kwargs) -> Phase:
        """Create and register a new phase."""
        phase = Phase(name=name, **kwargs)
        return self.add_phase(phase)

    def new_phase_like(self, phase_for_copying: Phase, name=None,
                       **kwargs) -> Phase:
        """Create a new phase copying an existing one's definition."""
        return phase_for_copying.create_new_copy(
            name, optimal_control_problem=self, **kwargs)

    def new_phases_like(self, phase_for_copying: Phase = None,
                        number: int = 1, names=None, **kwargs):
        """Create several copies of a phase
        (``pycollo/optimal_control_problem.py`` API parity; used by
        ``examples/delta_iii_launch_vehicle``)."""
        if names is None:
            names = [None] * number
        return tuple(self.new_phase_like(phase_for_copying, name=n, **kwargs)
                     for n in names)

    # -- problem-level variables/functions -----------------------------
    @property
    def parameter_variables(self) -> NamedVarTuple:
        return NamedVarTuple(self._parameter_variables,
                             [str(v) for v in self._parameter_variables])

    @parameter_variables.setter
    def parameter_variables(self, value):
        self._parameter_variables = _as_var_tuple(value)

    @property
    def number_parameter_variables(self) -> int:
        return len(self._parameter_variables)

    @property
    def objective_function(self):
        return self._objective_function

    @objective_function.setter
    def objective_function(self, value):
        self._objective_function = value

    @property
    def endpoint_constraints(self):
        if callable(self._endpoint_constraints):
            return self._endpoint_constraints
        return tuple(self._endpoint_constraints)

    @endpoint_constraints.setter
    def endpoint_constraints(self, value):
        if callable(value) and not _is_symbolic(value):
            self._endpoint_constraints = value
        else:
            self._endpoint_constraints = _as_var_tuple(value)

    @property
    def number_endpoint_constraints(self) -> int:
        if callable(self._endpoint_constraints):
            if self._num_endpoint_constraints is None:
                raise ValueError(
                    "Set ocp.number_endpoint_constraints when supplying "
                    "endpoint constraints as a callable.")
            return self._num_endpoint_constraints
        return len(self._endpoint_constraints)

    @number_endpoint_constraints.setter
    def number_endpoint_constraints(self, value):
        self._num_endpoint_constraints = int(value)

    @property
    def is_symbolic(self) -> bool:
        return any(p.is_symbolic for p in self._phases)

    # -- compile / solve ------------------------------------------------
    @property
    def backend(self):
        return self._backend

    @property
    def mesh_iterations(self):
        return self._mesh_iterations

    @property
    def num_mesh_iterations(self) -> int:
        return len(self._mesh_iterations)

    @property
    def solution(self):
        """The most recent mesh iteration's solution."""
        return self._solution

    @property
    def mesh_tolerance_met(self) -> bool:
        return bool(self._mesh_tolerance_met)

    def initialise(self):
        """Compile the problem: process bounds/guess, build the first mesh
        iteration's transcription (``optimal_control_problem.py:316-337``)."""
        from .transcription import CompiledOCP
        for phase in self._phases:
            phase.check_variables_and_equations()
        self._backend = CompiledOCP(self)
        self._initialised = True
        self._mesh_tolerance_met = False

    def solve(self, display_progress: Optional[bool] = None,
              device="cuda"):
        """Run the ph-adaptive mesh refinement loop
        (``optimal_control_problem.py:387-443``), every NLP solve on
        ``device`` (a torch device or its name; default the CUDA card,
        ``"cpu"`` to solve on the CPU).  Raises if no CUDA device is
        available and the CPU was not named."""
        device = solve_device(device)
        if not self._initialised:
            self.initialise()
        display = (self.settings.console_out_progress
                   if display_progress is None else display_progress)
        from .refinement import run_mesh_refinement_loop
        start = _time.perf_counter()
        result = run_mesh_refinement_loop(self._backend, display=display,
                                          device=device)
        self._mesh_iterations = result.iterations
        self._solution = result.solution
        self._mesh_tolerance_met = result.mesh_tolerance_met
        if display:
            console_out(
                f"Solve completed in "
                f"{format_time(_time.perf_counter() - start)}; "
                f"objective = {result.solution.objective:.8g}; "
                f"mesh tolerance met: {result.mesh_tolerance_met}")
        return self._solution

    def solve_batched(self, overrides=None, batch_size: Optional[int] = None,
                      devices=None):
        """Solve many perturbed instances of this problem simultaneously.

        ``overrides`` maps variable references (e.g. entries of
        ``phase.bounds.initial_state_constraints`` keys) to batched arrays.
        ``devices``: a sequence of torch devices (default the CUDA card;
        ``[torch.device("cpu")]`` for the CPU); with several, the batch is
        split into contiguous blocks in order, one per distinct device,
        each solved on its device as one batch (entries that repeat a
        device, e.g. ``[torch.device("cuda:0")] * 2``, pool into one block
        on it), distinct devices by a thread each.  The threads share the
        interpreter lock, so they are not expected to scale; over several
        cards run one process per card
        (:mod:`pycollo_tpu_torch.parallel.multihost`).  See
        :func:`pycollo_tpu_torch.parallel.batch.solve_theta_batch` for
        details.  New capability relative to the serial reference
        (SURVEY.md section 2 "absent" rows).
        """
        if not self._initialised:
            self.initialise()
        from .parallel.batch import solve_batched
        return solve_batched(self._backend, overrides=overrides,
                             batch_size=batch_size, devices=devices)

    def __repr__(self):
        return (f"OptimalControlProblem(name={self.name!r}, "
                f"phases={[p.name for p in self._phases]})")
