import os

# Tests run on the CPU backend with 8 virtual devices, so sharding logic
# is exercised without a GPU. XLA_FLAGS must be in the env before the
# CPU backend initialises. JAX_PLATFORMS defaults to cpu; the tests
# marked `gpu` run only when it names the GPU (JAX_PLATFORMS=cuda, as
# chip_smoke.py's test phase sets it) and skip otherwise.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has no GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return jax.devices()[0]
