"""chol_linv_roofline.mpc (%): the Cholesky-inverse kernel's least time at each launch's shape over its device time in the traced call."""

from harness.readers import chol_linv_roofline as read  # noqa: F401
