import os

# Tests run on the single real CPU device; only launch/dryrun.py (run in its
# own process) forces 512 placeholder devices.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (with a reason) without one")
