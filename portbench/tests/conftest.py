"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from
the root of the checkout. Tests marked ``cuda`` need a card and skip
without one (decided inside the test)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
