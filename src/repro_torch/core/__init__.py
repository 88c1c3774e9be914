"""Sketch configuration, state, hashing, addressing and dense queries."""
