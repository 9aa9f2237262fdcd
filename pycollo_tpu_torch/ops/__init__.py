"""Hand-written CUDA kernels for the hot linear-algebra ops.

Current kernels:

* :mod:`~pycollo_tpu_torch.ops.block_chol` — batched Cholesky factor +
  triangular inverse (``csrc/chol_linv.cu``, n <= 160, one thread block
  per matrix), the mixed-precision condensed-KKT factorization
  (``solver/linalg.py``): one launch for the default cart-pole mesh's
  148 x 148 matrices, four diagonal blocks for the refined mesh's 628.
  :mod:`~pycollo_tpu_torch.ops.bench_chol` times it on the card.
"""

from .block_chol import blocked_chol_linv, chol_inv, chol_inv_reference

__all__ = ["chol_inv", "chol_inv_reference", "blocked_chol_linv"]
