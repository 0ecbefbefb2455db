"""Data simulators."""
from .flocking import Flocking
from .lorenz import Lorenz

__all__ = ["Flocking", "Lorenz"]
