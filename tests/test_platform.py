"""Bring-up helpers: compile-cache location and the installed-package floor.

Each case runs in a fresh interpreter: the cache directory and the set of
importable modules are process-wide state.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, **env_overrides: str | None) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k, v in env_overrides.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


_CACHE_DIR = (
    "import jax\n"
    "from thor_slam_tpu.utils.platform import enable_compilation_cache\n"
    "enable_compilation_cache()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_honours_env(tmp_path):
    assert _run(_CACHE_DIR, JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout():
    assert _run(_CACHE_DIR, JAX_COMPILATION_CACHE_DIR=None) == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_entry_points_import_without_yaml():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None  # any `import yaml` now raises ImportError\n"
        "import scripts.run_slam, scripts.run_pipeline\n"
        "from thor_slam_tpu.utils.config import ConfigError, RunConfig, load_config\n"
        "assert RunConfig().synthetic.resolution == (640, 400)\n"
        "try:\n"
        "    load_config('config/slam_config.yaml')\n"
        "except ConfigError as e:\n"
        "    print('PyYAML' in str(e))\n"
    )
    assert _run(code) == "True"
