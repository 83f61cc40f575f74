"""
One compile-cache rule (ska_sdp_cip_tpu/utils/compile_cache.py): with
``JAX_COMPILATION_CACHE_DIR`` set, that directory is the only cache;
unset, the cache is the fixed in-checkout ``.jax_cache/``. Each case
runs in a fresh process, since JAX fixes its cache at first compile.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CHILD = """
import sys
from pathlib import Path
import jax
import jax.numpy as jnp
from ska_sdp_cip_tpu.utils import compile_cache
compile_cache.DEFAULT_DIR = Path(sys.argv[1])
print(compile_cache.configure_compile_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.block_until_ready(jax.jit(lambda x: x * 2 + 1)(jnp.ones(8)))
"""


def _run(tmp_path, env_dir):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["HOME"] = str(tmp_path / "home")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p
    )
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    default = tmp_path / "checkout" / ".jax_cache"
    result = subprocess.run(
        [sys.executable, "-c", CHILD, str(default)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    return result.stdout.strip().splitlines()[-1], default


def _entries(path):
    return [p for p in path.iterdir()] if path.is_dir() else []


def test_cache_env_variable_is_the_only_cache(tmp_path):
    env_dir = tmp_path / "env_cache"
    chosen, default = _run(tmp_path, env_dir)
    assert chosen == str(env_dir)
    assert _entries(env_dir)
    assert not default.exists()
    assert not (tmp_path / "home" / ".cache").exists()


def test_cache_defaults_to_checkout_directory(tmp_path):
    chosen, default = _run(tmp_path, None)
    assert chosen == str(default)
    assert _entries(default)


def test_default_directory_is_in_checkout_and_ignored():
    from ska_sdp_cip_tpu.utils.compile_cache import DEFAULT_DIR

    assert DEFAULT_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize(
    "path",
    [
        "bench.py",
        "chip_smoke.py",
        "ska_sdp_cip_tpu/apps/pipeline_app.py",
        "scripts/production_bench.py",
        "scripts/production_scale_bench.py",
        "scripts/production_rehearsal.py",
    ],
)
def test_entry_points_use_the_one_rule(path):
    source = (REPO / path).read_text()
    assert "configure_compile_cache" in source
    assert "jax_compilation_cache_dir" not in source
