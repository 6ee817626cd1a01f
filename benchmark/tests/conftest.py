"""The harness's tests import its modules as `benchmark/run.py` does: with
`benchmark/` and the checkout's root on the path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
