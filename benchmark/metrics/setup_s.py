"""setup_s (s): process start to the first timed call: imports, initialise(), the kernel's load or build, one warm-up batch."""

from harness.readers import setup_s as read  # noqa: F401
