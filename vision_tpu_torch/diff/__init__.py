"""Inverse rendering on torch autograd (`optimize.py`)."""
from . import optimize  # noqa: F401
