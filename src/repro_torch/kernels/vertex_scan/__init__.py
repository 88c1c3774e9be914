"""Vertex line-scan kernel, its wrappers, and label aggregates."""
