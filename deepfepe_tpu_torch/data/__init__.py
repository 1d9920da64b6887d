"""Data: the synthetic two-view generator."""

from .synthetic import SyntheticPairs

__all__ = ["SyntheticPairs"]
