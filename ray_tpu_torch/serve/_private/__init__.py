"""Serve-internal subsystems (reference python/ray/serve/_private)."""
