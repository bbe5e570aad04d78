"""The PyTorch/CUDA port (hyrise_tpu_torch) stands alone: it imports with
jax blocked, and no file of it imports jax or the JAX package.

The import runs in a subprocess because tests/conftest.py imports jax into
this process."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
# kernels/_build holds build outputs (ignored by git), not port sources
PORT_FILES = sorted(p for p in (REPO / "hyrise_tpu_torch").rglob("*.py")
                    if "_build" not in p.relative_to(REPO).parts) + [REPO / "chip_smoke.py"]


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_imports_with_jax_blocked():
    modules = [_module_name(p) for p in PORT_FILES]
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "leaked = sorted(m for m in sys.modules",
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'hyrise_tpu')",
        "                and sys.modules[m] is not None)",
        "assert not leaked, leaked",
        "print(len(sys.modules))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    source = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", source, re.M), path
    assert not re.search(r"^\s*(import hyrise_tpu\b|from hyrise_tpu[ .])", source, re.M), path


FRONT_END_MODULES = ("hyrise_tpu_torch.server", "hyrise_tpu_torch.console",
                     "hyrise_tpu_torch.parallel.scheduler", "hyrise_tpu_torch.tpcc.generator",
                     "hyrise_tpu_torch.utils.timer", "hyrise_tpu_torch.utils.profiling",
                     "hyrise_tpu_torch.utils.visualize", "hyrise_tpu_torch.utils.asserts")


def test_front_end_modules_are_covered():
    """The host front ends sit at the JAX package's paths and are among the
    files the two tests above import and scan."""
    scanned = {_module_name(p) for p in PORT_FILES}
    assert set(FRONT_END_MODULES) <= scanned
    for name in FRONT_END_MODULES:
        jax_path = REPO / "hyrise_tpu" / pathlib.Path(*name.split(".")[1:]).with_suffix(".py")
        assert jax_path.exists(), jax_path


def test_front_ends_start_nothing_at_import():
    """Importing the server and the console opens no socket and starts no
    thread (their entry points run under __main__ only)."""
    code = "\n".join([
        "import sys, threading",
        "sys.modules['jax'] = None",
        f"for name in {FRONT_END_MODULES!r}:",
        "    __import__(name)",
        "assert threading.active_count() == 1, threading.enumerate()",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
