"""Frozen copy of the port's rollout package (see ../__init__.py)."""
