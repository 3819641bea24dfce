import os
import sys

# Tests run on a virtual 8-device CPU mesh so that sharding paths are
# exercised without a GPU; chip_smoke.py and the benchmarks run on the card.
# JAX_PLATFORMS and the jax.config update both pin the CPU backend (the
# backend initializes lazily, so the XLA_FLAGS device-count flag still takes
# effect here). Tests marked ``gpu`` skip here.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
