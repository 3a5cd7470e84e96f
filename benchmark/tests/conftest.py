"""The benchmark's own tests: run them from the repository's root with
``python -m pytest benchmark/tests -q``.  Tests marked ``cuda`` need a card
and skip without one."""

import os
import sys
import tempfile

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where torch.cuda is "
                   "not available")


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test its own TMPDIR, where the archive loop keeps its journal,
    so that tests run side by side never share one."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
