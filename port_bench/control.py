"""Readings of the program and of its control, seed after seed, for
setting a cell's limits (see ``harness/control.py``)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.control import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(ROOT, sys.argv[1:]))
