"""Edge probe-walk query kernel and its wrappers."""
