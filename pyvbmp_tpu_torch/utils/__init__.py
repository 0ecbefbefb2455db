"""Numerics, linear algebra, node plumbing and state conversion."""
