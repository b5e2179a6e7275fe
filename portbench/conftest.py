"""The card marker of the repository's tests, for this folder's tests
when they run on their own."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
