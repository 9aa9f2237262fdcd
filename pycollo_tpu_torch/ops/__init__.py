"""Hand-written CUDA kernels for the hot linear-algebra ops.

Current kernels:

* :mod:`~pycollo_tpu_torch.ops.block_chol` — batched small-block Cholesky
  factor + triangular inverse (``csrc/block_chol.cu``), the diagonal-block
  step of the mixed-precision condensed-KKT factorization
  (``solver/linalg.py``).
"""

from .block_chol import blocked_chol_linv, chol_inv, chol_inv_reference

__all__ = ["chol_inv", "chol_inv_reference", "blocked_chol_linv"]
