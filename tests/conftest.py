"""Test harness setup.

Tests run on the CPU with 8 virtual devices (the standard JAX trick for
exercising sharding layouts without the devices, SURVEY.md §4) and with
x64 enabled so the NumPy compat oracle can be matched at f64.  The
platform and device count must be fixed before JAX initialises, so
when the environment does not already ask for them this module re-execs
pytest once with them set.

Tests that need a card carry the ``gpu`` marker and take the
``gpu_devices`` fixture, which skips them on the CPU.  Run them on a GPU
with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` (an explicit
non-CPU platform turns the re-exec off).
"""

import os
import sys

_GUARD = "_GRAVOMG_TEST_REEXEC"


def _needs_reexec() -> bool:
    if os.environ.get(_GUARD) == "1":
        return False
    if os.environ.get("JAX_PLATFORMS", "cpu") != "cpu":
        return False
    # The sharding tests assert on 8 virtual devices.
    return ("xla_force_host_platform_device_count"
            not in os.environ.get("XLA_FLAGS", ""))


if _needs_reexec():
    env = dict(os.environ)
    env[_GUARD] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    os.execvpe(sys.executable, [sys.executable, "-m", "pytest"]
               + sys.argv[1:], env)

os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Safety-net modes (SURVEY.md §5: the sanitizer analogue): run the suite
# with GRAVOMG_DEBUG_NANS=1 / GRAVOMG_DISABLE_JIT=1 to catch NaNs at
# their source or to exercise op-by-op semantics.
if os.environ.get("GRAVOMG_DEBUG_NANS") == "1":
    jax.config.update("jax_debug_nans", True)
if os.environ.get("GRAVOMG_DISABLE_JIT") == "1":
    jax.config.update("jax_disable_jit", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu_devices():
    """The GPU devices; skips the test where JAX has none.  Decided
    here, at run time, never while test modules are imported."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {devs[0].platform!r}")
    return devs


@pytest.fixture(autouse=True, scope="module")
def _unload_jit_code_between_modules():
    """Drop compiled-executable references after each test module.

    Long pytest processes accumulate thousands of XLA:CPU JIT'd
    executables; LLVM's section allocator eventually fails with
    'Unable to allocate section memory!' / 'Cannot allocate memory'
    and segfaults the process (observed reproducibly near the end of
    the full suite).  Clearing JAX's caches lets the loaded code
    sections unload; cross-module recompiles are cheap next to that.
    """
    yield
    jax.clear_caches()
