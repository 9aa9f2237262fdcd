"""Batched solves of one OCP over many instances."""
