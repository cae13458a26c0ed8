"""Utilities: the metrics logger."""
