"""Process introspection helpers for the $SYS stats (``system.Info``)."""

from __future__ import annotations

import sys


def rss_bytes() -> int:
    """Resident-set high-water mark of this process, in bytes.

    ``ru_maxrss`` is KiB on Linux but bytes on macOS; ``resource`` does not
    exist on Windows (where this returns 0 rather than breaking import).
    """
    try:
        import resource
    except ImportError:  # pragma: no cover - Windows
        return 0
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_maxrss * (1 if sys.platform == "darwin" else 1024)


def cpu_seconds() -> float:
    """Total user+system CPU seconds consumed by this process (the
    dashboard process recorder derives CPU%% from consecutive samples)."""
    try:
        import resource
    except ImportError:  # pragma: no cover - Windows
        return 0.0
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime
