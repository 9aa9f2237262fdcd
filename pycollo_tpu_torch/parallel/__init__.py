"""Batched, sharded and multi-process solves of one OCP over many
instances."""
