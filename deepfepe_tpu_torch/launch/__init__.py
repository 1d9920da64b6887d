"""Multi-process entry points."""
