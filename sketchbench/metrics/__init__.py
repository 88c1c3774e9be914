"""One reader a per-layer metric (``<name>.py``), and the byte counts."""
