"""Batched checking: the capacity ladder over many histories."""
