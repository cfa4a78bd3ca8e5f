"""The runtime sanitizer's fixtures for the PyTorch port's tests.

``san`` arms ``horovod_tpu_torch.analysis.sanitizer`` in raise mode for
one test, ``san_soft`` in soft (record-only) mode, and ``leak_audit``
fails the test that leaves a registered pool, buffer set or elastic
slot held beyond what it found.  Every fixture undoes what it did on
teardown — the forced mode, the recorded violations and audit
registrations, and any descriptor ``install`` or ``instrument_class``
put on a class — so a worker that runs other test files after this one
inherits nothing.
"""

from __future__ import annotations

import pytest

from horovod_tpu_torch.analysis import sanitizer


def _clean() -> None:
    sanitizer.uninstall()
    sanitizer.reset()
    sanitizer.audit_reset()


def _armed(monkeypatch, mode: str):
    monkeypatch.delenv("HOROVOD_SANITIZE", raising=False)
    monkeypatch.setenv("HVD_TPU_SANITIZE", mode)
    _clean()
    try:
        yield sanitizer
    finally:
        _clean()


@pytest.fixture
def san(monkeypatch):
    """Sanitizer armed in raise mode for the duration of one test."""
    yield from _armed(monkeypatch, "1")


@pytest.fixture
def san_soft(monkeypatch):
    """Soft (record-only) mode — for races whose violating access
    happens on a worker thread, where a raise would vanish."""
    yield from _armed(monkeypatch, "soft")


@pytest.fixture
def leak_audit():
    """Fail the test if a registered resource owner holds more at its
    end than at its start (the sanitizer must be armed for owners to
    register: use with ``san`` or ``san_soft``)."""
    baseline = sanitizer.audit_baseline()
    yield
    leaks = sanitizer.audit_check(record=False, baseline=baseline)
    assert not leaks, f"resource leak(s): {leaks}"
