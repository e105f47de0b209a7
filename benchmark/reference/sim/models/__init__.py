"""Frozen copy of the port's models package (see ../__init__.py)."""
