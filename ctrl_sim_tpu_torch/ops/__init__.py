"""Attention masks and the port's hand-written kernels."""
