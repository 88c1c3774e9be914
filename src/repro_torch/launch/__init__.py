"""Entry points of the port: the LM decode server."""
