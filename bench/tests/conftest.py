"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository's root (the repo's tier-1 run collects ``tests/`` only).  They
import the port from ``src/`` and never JAX."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
