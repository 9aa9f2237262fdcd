"""Batch-first interior-point NLP solver and its linear algebra."""
