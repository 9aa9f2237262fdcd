"""block_products_per_iter.reentry (products/iter): batched products of the block algebra (blocked_chol_linv.products) per IPM loop trip."""

from harness.blocked import block_products_per_iter as read  # noqa: F401
