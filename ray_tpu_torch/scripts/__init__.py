"""CLI entry points (reference python/ray/scripts/)."""
