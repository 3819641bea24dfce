"""Process setup (utils/platform.py): the persistent compilation cache lives
where JAX_COMPILATION_CACHE_DIR says, else at the fixed <checkout>/.jax_cache;
PM_PLATFORM selects the backend explicitly."""

import os
import subprocess
import sys

from gr4_packet_modem_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# compile one program with the cache thresholds at zero, then list the cache
_PROBE = """
from gr4_packet_modem_tpu.utils.platform import setup
setup()
import jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
print(jax.devices()[0].platform)
"""


def _run(cwd, env_extra, pythonpath):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PM_PLATFORM")}
    env.update(env_extra, PYTHONPATH=pythonpath)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=cwd, env=env, check=True,
        capture_output=True, text=True, timeout=300,
    )
    return out.stdout.split()


def test_default_cache_is_checkout_dir():
    assert platform.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_lands_in_env_dir(tmp_path):
    cache = tmp_path / "cache"
    cfg, _ = _run(REPO, {"JAX_COMPILATION_CACHE_DIR": str(cache)}, REPO)
    assert cfg == str(cache)
    assert any(cache.iterdir()), "no cache entry written"


def test_cache_lands_in_checkout_without_env(tmp_path):
    # a checkout whose package is the repo's (the default path is derived
    # from the package location, so a linked copy gets its own cache)
    (tmp_path / "gr4_packet_modem_tpu").symlink_to(
        os.path.join(REPO, "gr4_packet_modem_tpu")
    )
    cfg, plat = _run(str(tmp_path), {"PM_PLATFORM": "cpu"}, str(tmp_path))
    assert cfg == str(tmp_path / ".jax_cache")
    assert any((tmp_path / ".jax_cache").iterdir()), "no cache entry written"
    assert plat == "cpu"
