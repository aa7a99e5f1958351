"""Parallel strategies of the port: data-parallel process groups (dist,
mesh) and the banded sparse stage (sparse_spatial)."""
