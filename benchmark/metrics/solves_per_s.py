"""solves_per_s (solves/s): certified instances over the window's calls, per second of the window."""

from harness.readers import solves_per_s as read  # noqa: F401
