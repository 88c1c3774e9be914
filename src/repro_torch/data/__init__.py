"""Seeded graph-stream generators."""
