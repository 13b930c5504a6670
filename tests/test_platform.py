"""Platform plumbing: the compile-cache location, the profiler hook and
chip_smoke.py's refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from openbts_ttsou_tpu.utils import compile_cache, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings a test changes."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_repo(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_trace_propagates_errors_from_the_body(tmp_path):
    entered = []
    with pytest.raises(ValueError, match="boom"):
        with profiling.trace(str(tmp_path)):
            entered.append(1)
            raise ValueError("boom")
    assert entered == [1]  # the body ran once, and was not re-entered


def test_maybe_trace_without_env_runs_untraced(monkeypatch):
    monkeypatch.delenv("OPENBTS_TRACE", raising=False)
    with profiling.maybe_trace():
        pass


def test_chip_smoke_refuses_cpu_devices():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices()[0].platform)
    assert e.value.code not in (0, None)
    chip_smoke.require_gpu("gpu")


def test_chip_smoke_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    with pytest.raises(ValueError):
        json.loads(lines[-1] if lines else "")
