"""Shared pytest config + helpers for multi-device subprocess tests."""
import os
import re
import subprocess
import sys
import textwrap

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end test")
    config.addinivalue_line("markers", "multidevice: runs a subprocess with forced host devices")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips itself without one")


def pytest_collection_modifyitems(config, items):
    """Every multidevice (subprocess) test is also ``slow``, so
    ``pytest -m "not slow"`` / ``scripts/test.sh -m "not slow"`` deselects
    the whole fresh-interpreter tier in one flag."""
    for item in items:
        if item.get_closest_marker("multidevice") and not item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.slow)


def optional_hypothesis():
    """``(given, settings, st)`` — real hypothesis, or skipping stubs.

    hypothesis is an optional dependency: when it is missing, property
    tests are skipped (not errored at collection) and the rest of the
    module still runs. Usage in a test module::

        from conftest import optional_hypothesis
        given, settings, st = optional_hypothesis()
    """
    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st

        return given, settings, st
    except ModuleNotFoundError:
        skip = pytest.mark.skip(reason="hypothesis not installed")

        class _AnyStrategy:
            """Accepts any strategy construction; values are never drawn."""

            def __getattr__(self, name):
                return lambda *a, **k: None

        def given(*a, **k):
            return lambda fn: skip(fn)

        def settings(*a, **k):
            return lambda fn: fn

        return given, settings, _AnyStrategy()


def run_with_devices(code: str, num_devices: int, timeout: int = 600) -> str:
    """Run ``code`` in a fresh python with N forced host devices.

    The main test process keeps its device count (jax locks it at first
    backend init), so anything needing a different mesh runs out of
    process. Any inherited device-count flag is stripped so the requested
    count always wins. Raises on non-zero exit; returns stdout.
    """
    env = dict(os.environ)
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "", env.get("XLA_FLAGS", "")
    ).strip()
    env["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={num_devices}"
    ).strip()
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
        )
    return proc.stdout
