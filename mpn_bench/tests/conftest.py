"""The benchmark's tests: ``python -m pytest mpn_bench/tests`` from the
repository root.  Tests marked ``chip`` need a CUDA device; each decides
inside itself and skips on a machine without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skipped without one")
