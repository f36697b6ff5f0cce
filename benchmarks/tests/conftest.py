"""The benchmark's own tests. They are not under the repository's
`tests/`; run them with `python -m pytest benchmarks/tests -q`. Tests
marked `chip` need a CUDA device and skip without one; on the chip:
`python -m pytest benchmarks/tests -q -m chip`."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")
