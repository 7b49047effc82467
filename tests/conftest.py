import os
import sys

# src layout on path regardless of how pytest is invoked
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# IMPORTANT: the dry-run's 512-device override must never leak into tests;
# smoke tests and benches see the host's real (1-device) platform.
os.environ.pop("XLA_FLAGS", None)

# Opt-in lock-order sanitizer (DESIGN.md §11): REPRO_LOCKDEP=1 patches the
# threading.Lock/RLock/Condition factories *before* any fabric module is
# imported, so every fabric lock the suite creates is tracked.  The
# session teardown fails the run on any recorded cycle or lock-held-
# across-RPC violation.
from repro.analysis import lockdep as _lockdep  # noqa: E402

if _lockdep.enabled():
    _lockdep.install()

import time  # noqa: E402

import pytest  # noqa: E402


def poll_until(pred, timeout: float = 8.0, interval: float = 0.02,
               msg: str = "condition"):
    """Deflake helper: poll ``pred`` until truthy, bounded by
    ``timeout`` (monotonic).  Returns the first truthy value, so tests
    can both wait for and capture a result.  Use this instead of fixed
    ``time.sleep`` waits — it converges as fast as the system actually
    is and fails loudly with ``msg`` instead of silently racing."""
    deadline = time.monotonic() + timeout
    while True:
        value = pred()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(
                f"timed out after {timeout:.1f}s waiting for {msg}")
        time.sleep(interval)


def wait_event(event, timeout: float = 8.0, msg: str = "event"):
    """Deflake helper: bounded ``threading.Event`` wait that fails
    loudly instead of letting a test limp past an unset event."""
    if not event.wait(timeout):
        raise AssertionError(
            f"timed out after {timeout:.1f}s waiting for {msg}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-second quorum/chaos tests; deselect with "
        "-m 'not slow' for a fast local loop")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card and skips without one; run on the card "
        "with -m gpu")


@pytest.fixture(scope="session", autouse=True)
def _lockdep_gate():
    yield
    if _lockdep.enabled():
        _lockdep.assert_clean()
