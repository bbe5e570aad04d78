"""Small utilities (reference: src/lib/utils/ — timer.hpp,
format_bytes.cpp, format_duration.cpp, performance_warning.hpp).

A copy of hyrise_tpu/utils/timer.py."""

from __future__ import annotations

import sys
import time
from typing import Set


class Timer:
    """Reference: utils/timer.hpp — lap timer returning elapsed seconds."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        out = now - self._t0
        self._t0 = now
        return out

    def lap_formatted(self) -> str:
        return format_duration(self.lap())


def format_bytes(n: float) -> str:
    """Reference: utils/format_bytes.cpp."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.2f}PiB"


def format_duration(seconds: float) -> str:
    """Reference: utils/format_duration.cpp."""
    if seconds < 1e-6:
        return f"{seconds * 1e9:.0f}ns"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f}ms"
    if seconds < 60:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60)
    return f"{int(m)}m {s:.0f}s"


_warned: Set[str] = set()


def performance_warning(message: str) -> None:
    """One-shot performance warnings (reference:
    utils/performance_warning.hpp:28-47 — each callsite fires once)."""
    if message in _warned:
        return
    _warned.add(message)
    print(f"[PERF] {message}", file=sys.stderr)


def reset_performance_warnings() -> None:
    _warned.clear()
