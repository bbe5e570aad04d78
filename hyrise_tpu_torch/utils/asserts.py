"""Device-side assertions, behind the switch HYRISE_DEVICE_ASSERTS.

Port of hyrise_tpu/utils/asserts.py (reference: DebugAssert,
utils/assert.hpp, and the sanitizer builds of its CI). An index out of
range in a gather is a wrong answer or a device fault, found late; with
HYRISE_DEVICE_ASSERTS=1 (tests, debug runs) `device_assert` reduces its
condition on the condition's device and reads the one result on the host,
raising DeviceAssertionError if it fails. Off (the default), it returns at
once and launches nothing.
"""

from __future__ import annotations

import os

import torch


def enabled() -> bool:
    return os.environ.get("HYRISE_DEVICE_ASSERTS", "0") not in ("0", "false")


class DeviceAssertionError(AssertionError):
    pass


def device_assert(cond, label: str) -> None:
    """Assert that `cond` (a bool tensor or a Python bool) holds everywhere.
    No-op unless HYRISE_DEVICE_ASSERTS=1."""
    if not enabled():
        return
    held = bool(torch.all(cond).item()) if isinstance(cond, torch.Tensor) else bool(cond)
    if not held:
        raise DeviceAssertionError(f"device assertion failed: {label}")


def assert_indices_in_range(indices: torch.Tensor, limit: int, label: str) -> None:
    """Every gather index lies in [0, limit)."""
    if not enabled():
        return
    device_assert((indices >= 0) & (indices < limit), label)
