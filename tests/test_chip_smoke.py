"""chip_smoke.py's checks at small size, the device guard, the compile
cache location, and the multi-device dryrun guard.

The phases themselves run on the CPU here at 4k; the ``gpu``-marked
tests run the TF32-sensitive phases on a card and skip elsewhere."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def main4k():
    return chip_smoke.main_path(4096, timed_reps=1)


def test_main_path_4k_reaches_tolerance(main4k):
    assert main4k["levels"][0] == 4096 and len(main4k["levels"]) >= 2
    for name in ("mg_solve", "mg_solve_bf16", "mg_pcg"):
        r = main4k[name]
        assert r["rel"] <= chip_smoke.RTOL, (name, r)
        assert r["true_rel_f64"] <= r["true_bound"], (name, r)
    # The attach path ran: level 0 carries a slab form, the next levels
    # uniform block-dense forms.
    assert hasattr(main4k["sol"].levels[0].banded, "buckets")


def test_spmv_forms_agree_4k(main4k):
    rows = chip_smoke.spmv_table(main4k["sol"], timed=False)
    ops = {(r["level"], r["op"]) for r in rows}
    assert {(0, "A"), (0, "U"), (0, "U^T")} <= ops
    for r in rows:
        for f in r["forms"].values():
            assert f["err_scipy"] <= f["tol"] and f["err_ell"] <= f["tol"]
            assert f["bytes"] > 0
    attached = [r for r in rows if "attached" in r["forms"]]
    assert attached and all("bf16" in r["forms"] for r in attached)


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_smoke_script_fails_without_gpu(tmp_path, alone):
    """No accelerator, or no package beside the script: non-zero exit
    and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), "--n", "1000"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "repo"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    from gravomg_tpu import compile_cache

    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".bench_cache", "xla")
    assert compile_cache.compile_cache_dir() == want
    old = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_dryrun_multichip_raises_off_cpu(monkeypatch):
    import __graft_entry__ as entry

    monkeypatch.delenv(entry._DRYRUN_GUARD, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        entry.dryrun_multichip(n)


@pytest.mark.gpu
def test_knn_canary_on_gpu(gpu_devices):
    assert chip_smoke.knn_canary(20_000) >= 0


@pytest.mark.gpu
def test_spmv_forms_on_gpu(gpu_devices):
    res = chip_smoke.main_path(50_000, timed_reps=1)
    rows = chip_smoke.spmv_table(res["sol"], timed=False)
    assert rows and np.isfinite(res["t_vcycle_ms"])
