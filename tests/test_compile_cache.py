"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins; otherwise the cache
lives at one fixed, git-ignored path inside the checkout. Each case runs in a
subprocess so the cache setting never leaks into other tests."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = (
    "import json, jax\n"
    "from particle_simulator_tpu.utils.compile_cache import cache_dir, "
    "enable_compilation_cache\n"
    "active = enable_compilation_cache()\n"
    "print(json.dumps({'active': active, 'cache_dir': cache_dir(), "
    "'jax': jax.config.jax_compilation_cache_dir}))\n"
)


def _probe(env_dir=None):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_var_is_the_cache_dir(tmp_path):
    got = _probe(tmp_path / "from_env")
    assert got["active"] == got["cache_dir"] == str(tmp_path / "from_env")
    assert got["jax"] == str(tmp_path / "from_env")  # JAX read it itself


def test_default_cache_is_fixed_inside_the_checkout():
    got = _probe()
    assert got["active"] == got["jax"] == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache").is_dir()
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()
    # the path is part of the cache key: a second process gets the same one
    assert _probe()["active"] == got["active"]
