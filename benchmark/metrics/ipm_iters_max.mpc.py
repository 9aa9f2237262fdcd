"""ipm_iters_max.mpc (iters): IPM loop trips per call (the batch's largest iteration count), averaged over the window's calls."""

from harness.readers import ipm_iters_max as read  # noqa: F401
