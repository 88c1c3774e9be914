"""Window ring and the stacked insert engine."""
