"""Frozen copy of the port's ops package (see ../__init__.py)."""
