"""Synthetic registration volumes."""
