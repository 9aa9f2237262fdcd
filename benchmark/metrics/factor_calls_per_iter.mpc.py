"""factor_calls_per_iter.mpc (calls/iter): blocked_chol_linv calls per IPM loop trip; 1 means no escalation trip."""

from harness.readers import factor_calls_per_iter as read  # noqa: F401
