"""ipm_iter_ms.reentry (ms): solve time per IPM loop trip over the window's calls."""

from harness.readers import ipm_iter_ms as read  # noqa: F401
