"""Verdict provenance (the in-memory part of the JAX package's ``obs``)."""
