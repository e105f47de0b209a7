"""Frozen copy of the port's env package (see ../__init__.py)."""
