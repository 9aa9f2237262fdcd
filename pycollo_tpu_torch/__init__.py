"""pycollo_tpu_torch: multiphase optimal control in PyTorch, with CUDA kernels.

The PyTorch port of :mod:`pycollo_tpu` (direct orthogonal collocation for
multiphase optimal control): user dynamics are sympy expressions lambdified
into PyTorch (or PyTorch callables), the transcribed NLP is evaluated for all
mesh nodes of all instances in batched passes, and the NLP is solved by a
batch-first condensed-space primal-dual interior-point method whose
mixed-precision factorization runs a hand-written Hopper kernel on CUDA
(:mod:`pycollo_tpu_torch.ops`).  Every tensor the package creates names its
dtype and device; nothing here changes global defaults.

Public API parity with ``pycollo/__init__.py:1-16``.
"""

from .bounds import EndpointBounds, PhaseBounds          # noqa: F401
from .guess import EndpointGuess, PhaseGuess             # noqa: F401
from .mesh import PhaseMesh                              # noqa: F401
from .ocp import OptimalControlProblem                   # noqa: F401
from .phase import Phase                                 # noqa: F401
from .settings import Settings                           # noqa: F401
from .structures import Endpoints, PhaseEndpoints        # noqa: F401
from .user_scaling import EndpointScaling, PhaseScaling  # noqa: F401

__all__ = [
    "OptimalControlProblem",
    "Phase",
    "EndpointBounds",
    "PhaseBounds",
    "EndpointGuess",
    "PhaseGuess",
    "PhaseMesh",
    "Settings",
    "Endpoints",
    "PhaseEndpoints",
]

__version__ = "0.1.0"
