"""The benchmark's own tests run on the CPU at tiny sizes:

    python -m pytest benchmark/tests -q

from the root of the repository (tier-1's ``pytest tests/`` does not
collect them). A test that needs a card is marked ``cuda`` and skips
without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
