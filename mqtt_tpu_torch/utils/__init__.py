"""Shared host-side utilities."""

from .gctune import freeze_index, tune_for_throughput
from .locked import LockedMap

__all__ = ["LockedMap", "freeze_index", "tune_for_throughput"]
