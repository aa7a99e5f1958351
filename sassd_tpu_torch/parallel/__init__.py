"""Parallel strategies of the port (the banded sparse stage)."""
