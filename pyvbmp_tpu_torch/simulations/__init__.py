"""Data simulators."""
from .lorenz import Lorenz

__all__ = ["Lorenz"]
