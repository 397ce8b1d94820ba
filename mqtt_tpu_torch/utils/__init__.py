"""Shared host-side utilities."""

from .gctune import freeze_index, tune_for_throughput
from .locked import LockedMap
from .proc import rss_bytes

__all__ = ["LockedMap", "freeze_index", "rss_bytes", "tune_for_throughput"]
