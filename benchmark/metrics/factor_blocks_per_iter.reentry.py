"""factor_blocks_per_iter.reentry (blocks/iter): diagonal blocks factored (blocked_chol_linv.blocks) per IPM loop trip."""

from harness.blocked import factor_blocks_per_iter as read  # noqa: F401
