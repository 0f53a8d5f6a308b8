"""The benchmark's tests run from the checkout's root:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
