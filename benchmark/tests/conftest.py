"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
root of the checkout.  Tests marked ``gpu`` need a CUDA device and skip
without one, deciding inside the test."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the PyTorch port's kernels); skips without one")
