"""Shared host-side utilities."""

from .locked import LockedMap

__all__ = ["LockedMap"]
