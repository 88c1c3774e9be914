"""The load generator: streams, request mixes and arrival arithmetic."""
