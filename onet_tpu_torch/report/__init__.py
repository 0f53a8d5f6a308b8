"""Reports: epoch logs, tables, workbooks and figures."""

from __future__ import annotations

import importlib.util


def can_draw() -> bool:
    """True where matplotlib is installed. ``report/curves.py`` imports it
    at module level, so the drivers and the command line draw their
    figures only where this holds; everything else runs without them."""
    return importlib.util.find_spec("matplotlib") is not None
