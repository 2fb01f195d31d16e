"""Reductions over the mesh."""
