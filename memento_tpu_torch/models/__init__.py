"""Generative models: the simulation suite."""

from . import simulate

__all__ = ["simulate"]
