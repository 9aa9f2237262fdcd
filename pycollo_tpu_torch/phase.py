"""Phase definition for multiphase optimal control problems.

Capability parity with ``pycollo/phase.py`` (670 LoC): a phase owns state
variables ``y``, control variables ``u``, integrand functions (integral
variables ``q``), time variables ``t0``/``tF``, state equations, path
constraints, per-phase auxiliary data, bounds, guess and mesh; it exposes
auto-created endpoint variables (``pycollo/phase.py:324-354``) and validates
that the number of state equations matches the number of states
(``pycollo/phase.py:571-630``).  ``create_new_copy`` clones a phase for
multiphase problems (``pycollo/phase.py:156-214``).

Two frontends share this class:

* **symbolic**: variables are ``sympy.Symbol``s and equations are sympy
  expressions (drop-in parity with the reference user API); the expressions
  are later lambdified into PyTorch functions by
  :mod:`pycollo_tpu_torch.sym_backend`.
* **functional**: variables are name strings and equations are PyTorch
  callables ``f(y, u, t, s) -> array`` evaluated per mesh node.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

from .bounds import PhaseBounds
from .guess import PhaseGuess
from .mesh import PhaseMesh
from .user_scaling import PhaseScaling


class NamedVarTuple(tuple):
    """Tuple of variables with attribute access by variable name.

    Replaces the reference's dynamic namedtuple containers
    (``pycollo/utils.py:145-313``).
    """

    def __new__(cls, items, names):
        self = super().__new__(cls, tuple(items))
        object.__setattr__(self, "_name_map",
                           {str(n): v for n, v in zip(names, items)})
        return self

    def __getattr__(self, name):
        try:
            return self._name_map[name]
        except KeyError as exc:
            raise AttributeError(name) from exc


def _is_symbolic(obj) -> bool:
    try:
        import sympy
        return isinstance(obj, sympy.Basic)
    except ImportError:  # pragma: no cover
        return False


def _as_var_tuple(value) -> tuple:
    if value is None:
        return ()
    if isinstance(value, (str, bytes)) or _is_symbolic(value):
        return (value,)
    if isinstance(value, Iterable):
        return tuple(value)
    return (value,)


class Phase:
    """One continuous-time phase of an optimal control problem."""

    def __init__(self, optimal_control_problem=None, *, name=None,
                 state_variables=None, control_variables=None,
                 state_equations=None, path_constraints=None,
                 integrand_functions=None, auxiliary_data=None,
                 bounds=None, guess=None, mesh=None):
        self.name = name
        self.optimal_control_problem = None
        self._phase_number = None
        self._state_variables = ()
        self._control_variables = ()
        self._state_equations = ()
        self._path_constraints = ()
        self._integrand_functions = ()
        self._endpoint_cache = {}
        self.auxiliary_data = dict(auxiliary_data) if auxiliary_data else {}
        self.bounds = bounds if bounds is not None else PhaseBounds(phase=self)
        self.bounds.phase = self
        self.guess = guess if guess is not None else PhaseGuess(phase=self)
        self.guess.phase = self
        self.mesh = mesh if mesh is not None else PhaseMesh(phase=self)
        self.mesh.phase = self
        self.scaling = PhaseScaling(phase=self)

        if state_variables is not None:
            self.state_variables = state_variables
        if control_variables is not None:
            self.control_variables = control_variables
        if state_equations is not None:
            self.state_equations = state_equations
        if path_constraints is not None:
            self.path_constraints = path_constraints
        if integrand_functions is not None:
            self.integrand_functions = integrand_functions

        if optimal_control_problem is not None:
            optimal_control_problem.add_phase(self)

    # -- registration --------------------------------------------------
    @property
    def phase_number(self) -> Optional[int]:
        return self._phase_number

    @property
    def i(self) -> Optional[int]:
        return self._phase_number

    # -- variables -----------------------------------------------------
    @property
    def state_variables(self) -> NamedVarTuple:
        return NamedVarTuple(self._state_variables,
                             [str(v) for v in self._state_variables])

    @state_variables.setter
    def state_variables(self, value):
        self._state_variables = _as_var_tuple(value)
        self._endpoint_cache.clear()

    @property
    def control_variables(self) -> NamedVarTuple:
        return NamedVarTuple(self._control_variables,
                             [str(v) for v in self._control_variables])

    @control_variables.setter
    def control_variables(self, value):
        self._control_variables = _as_var_tuple(value)

    @property
    def number_state_variables(self) -> int:
        return len(self._state_variables)

    @property
    def number_control_variables(self) -> int:
        return len(self._control_variables)

    # -- equations -----------------------------------------------------
    @property
    def state_equations(self):
        if callable(self._state_equations):
            return self._state_equations
        return NamedVarTuple(self._state_equations,
                             [str(v) for v in self._state_variables])

    @state_equations.setter
    def state_equations(self, value):
        if isinstance(value, dict):
            # Dict keyed by state variable (reference API form, used by
            # ``tests/integration/test_multiphase.py:42``).
            by_name = {str(k): v for k, v in value.items()}
            missing = [str(v) for v in self._state_variables
                       if str(v) not in by_name]
            if missing:
                raise ValueError(
                    f"State equations dict missing entries for {missing}.")
            self._state_equations = tuple(by_name[str(v)]
                                          for v in self._state_variables)
        elif callable(value) and not _is_symbolic(value):
            self._state_equations = value
        else:
            self._state_equations = _as_var_tuple(value)

    @property
    def path_constraints(self):
        if callable(self._path_constraints):
            return self._path_constraints
        return tuple(self._path_constraints)

    @path_constraints.setter
    def path_constraints(self, value):
        if callable(value) and not _is_symbolic(value):
            self._path_constraints = value
        else:
            self._path_constraints = _as_var_tuple(value)

    @property
    def integrand_functions(self):
        if callable(self._integrand_functions):
            return self._integrand_functions
        return tuple(self._integrand_functions)

    @integrand_functions.setter
    def integrand_functions(self, value):
        if callable(value) and not _is_symbolic(value):
            self._integrand_functions = value
        else:
            self._integrand_functions = _as_var_tuple(value)

    #: number of path constraints / integrand functions.  For the
    #: functional frontend these cannot be inferred from a callable, so the
    #: user sets ``number_path_constraints`` / ``number_integrand_functions``
    #: explicitly (attributes below); for the symbolic frontend they come
    #: from the expression tuples.
    _num_path_constraints: Optional[int] = None
    _num_integrand_functions: Optional[int] = None

    @property
    def number_path_constraints(self) -> int:
        if callable(self._path_constraints):
            if self._num_path_constraints is None:
                raise ValueError(
                    "Set phase.number_path_constraints when supplying path "
                    "constraints as a callable.")
            return self._num_path_constraints
        return len(self._path_constraints)

    @number_path_constraints.setter
    def number_path_constraints(self, value):
        self._num_path_constraints = int(value)

    @property
    def number_integrand_functions(self) -> int:
        if callable(self._integrand_functions):
            if self._num_integrand_functions is None:
                raise ValueError(
                    "Set phase.number_integrand_functions when supplying "
                    "integrand functions as a callable.")
            return self._num_integrand_functions
        return len(self._integrand_functions)

    @number_integrand_functions.setter
    def number_integrand_functions(self, value):
        self._num_integrand_functions = int(value)

    # -- endpoint / time / integral variables (symbolic frontend) ------
    def _endpoint_symbol(self, key: str):
        """Stable auto-created symbol (``pycollo/phase.py:324-354``)."""
        sym = self._endpoint_cache.get(key)
        if sym is None:
            import sympy
            suffix = f"_P{self._phase_number}" \
                if self._phase_number is not None else ""
            sym = sympy.Symbol(key + suffix)
            self._endpoint_cache[key] = sym
        return sym

    @property
    def initial_time_variable(self):
        return self._endpoint_symbol("_t0")

    @property
    def final_time_variable(self):
        return self._endpoint_symbol("_tF")

    @property
    def initial_state_variables(self) -> NamedVarTuple:
        syms = [self._endpoint_symbol(f"_{v}_t0")
                for v in self._state_variables]
        return NamedVarTuple(syms, [str(v) for v in self._state_variables])

    @property
    def final_state_variables(self) -> NamedVarTuple:
        syms = [self._endpoint_symbol(f"_{v}_tF")
                for v in self._state_variables]
        return NamedVarTuple(syms, [str(v) for v in self._state_variables])

    @property
    def integral_variables(self) -> tuple:
        nq = self.number_integrand_functions
        return tuple(self._endpoint_symbol(f"_q{j}") for j in range(nq))

    # -- validation ----------------------------------------------------
    def check_variables_and_equations(self):
        """Validate #states == #state-equations (``pycollo/phase.py:571-630``)."""
        if not self._state_variables:
            raise ValueError(f"Phase {self.name!r} has no state variables.")
        if not callable(self._state_equations):
            if len(self._state_equations) != len(self._state_variables):
                raise ValueError(
                    f"Phase {self.name!r} has "
                    f"{len(self._state_variables)} state variables but "
                    f"{len(self._state_equations)} state equations.")

    @property
    def is_symbolic(self) -> bool:
        return any(_is_symbolic(v) for v in self._state_variables)

    # -- copying -------------------------------------------------------
    def create_new_copy(self, name=None, optimal_control_problem=None, *,
                        copy_state_variables: bool = True,
                        copy_control_variables: bool = True,
                        copy_state_equations: bool = True,
                        copy_path_constraints: bool = True,
                        copy_integrand_functions: bool = True,
                        copy_state_endpoint_constraints: bool = False,
                        copy_bounds: bool = True,
                        copy_mesh: bool = True,
                        copy_scaling: bool = True,
                        copy_guess: bool = True):
        """Clone this phase's definition with granular copy flags
        (signature parity with ``pycollo/phase.py:156-214``)."""
        import copy as _copy
        new = Phase(name=name)
        b, g = self.bounds, self.guess
        if copy_state_variables:
            new._state_variables = self._state_variables
            if copy_bounds:
                new.bounds.state_variables = _copy.deepcopy(
                    b.state_variables)
            if copy_guess:
                new.guess.state_variables = _copy.deepcopy(
                    g.state_variables)
        if copy_control_variables:
            new._control_variables = self._control_variables
            if copy_bounds:
                new.bounds.control_variables = _copy.deepcopy(
                    b.control_variables)
            if copy_guess:
                new.guess.control_variables = _copy.deepcopy(
                    g.control_variables)
        if copy_state_equations:
            new._state_equations = self._state_equations
        if copy_path_constraints:
            new._path_constraints = self._path_constraints
            new._num_path_constraints = self._num_path_constraints
            if copy_bounds:
                new.bounds.path_constraints = _copy.deepcopy(
                    b.path_constraints)
        if copy_integrand_functions:
            new._integrand_functions = self._integrand_functions
            new._num_integrand_functions = self._num_integrand_functions
            if copy_bounds:
                new.bounds.integral_variables = _copy.deepcopy(
                    b.integral_variables)
            if copy_guess:
                new.guess.integral_variables = _copy.deepcopy(
                    g.integral_variables)
        if copy_state_endpoint_constraints and copy_bounds:
            new.bounds.initial_state_constraints = _copy.deepcopy(
                b.initial_state_constraints)
            new.bounds.final_state_constraints = _copy.deepcopy(
                b.final_state_constraints)
        if copy_bounds:
            new.bounds.initial_time = b.initial_time
            new.bounds.final_time = b.final_time
        if copy_guess and g.time is not None:
            new.guess.time = g.time
        new.auxiliary_data = dict(self.auxiliary_data)
        if copy_mesh:
            new.mesh = PhaseMesh(
                phase=new,
                number_mesh_sections=self.mesh.number_mesh_sections,
                mesh_section_sizes=self.mesh.mesh_section_sizes,
                number_mesh_section_nodes=self.mesh.number_mesh_section_nodes)
        if optimal_control_problem is not None:
            optimal_control_problem.add_phase(new)
        return new

    @staticmethod
    def create_new_copy_like(phase_for_copying: "Phase", name=None,
                             **kwargs):
        """Constructor to copy a phase (``pycollo/phase.py:216-219``)."""
        return phase_for_copying.create_new_copy(name, **kwargs)

    def __repr__(self):
        return (f"Phase(name={self.name!r}, "
                f"states={[str(v) for v in self._state_variables]}, "
                f"controls={[str(v) for v in self._control_variables]})")
