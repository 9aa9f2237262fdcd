"""chol_linv_roofline.reentry (%): the Cholesky-inverse kernel's least time at each launch's block shape over its device time in the traced call."""

from harness.blocked import chol_linv_roofline as read  # noqa: F401
