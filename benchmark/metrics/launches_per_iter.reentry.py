"""launches_per_iter.reentry (launches/iter): device kernels in the traced call per IPM loop trip."""

from harness.readers import launches_per_iter as read  # noqa: F401
