"""Block-binned first-fit insert kernel and its wrappers."""
