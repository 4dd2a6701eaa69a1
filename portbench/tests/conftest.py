"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository (on the CPU; the tests marked ``cuda`` skip
there and run on a card)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
