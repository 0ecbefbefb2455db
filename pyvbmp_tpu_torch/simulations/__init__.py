"""Data simulators."""
from .cartthingy import cartthingy
from .flame import FlameSimulator
from .flocking import Flocking
from .forager import Forager
from .lorenz import Lorenz
from .newtons_cradle import NewtonsCradle

__all__ = ["Flocking", "FlameSimulator", "Forager", "Lorenz", "NewtonsCradle", "cartthingy"]
