"""DCOP model objects (only what the compiled representation needs)."""

from .objects import Domain

__all__ = ["Domain"]
