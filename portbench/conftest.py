"""The benchmark's own tests (`python -m pytest portbench -q`); the ones
marked `cuda` run on the card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs on the H100)")
