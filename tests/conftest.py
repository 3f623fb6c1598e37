"""Test harness: force CPU with 8 virtual devices so sharding tests run
without accelerator hardware (SURVEY.md §4).

Tests marked `gpu` need a CUDA device: the `gpu_device` fixture skips them
on the CPU, and `python chip_smoke.py` runs them on the card.
"""

import os

# chip_smoke.py runs the gpu-marked tests in its own process on the card
ON_CARD = os.environ.get("SDSLAM_TESTS_ON_CARD") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
# tests that invoke cli.main() IN-PROCESS must not arm the persistent
# compile cache for the rest of the suite (jax.config is process-global;
# XLA:CPU persistent-cache reads have crashed full-suite runs — see the
# cache note below). Subprocess e2e tests override this in their env.
os.environ.setdefault("SDSLAM_JAX_CACHE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if not ON_CARD and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# XLA:CPU's LLVM JIT accumulates ~hundreds of memory mappings per compiled
# executable and never unmaps them; a full fast-tier run crosses the kernel's
# default vm.max_map_count (65530) after ~80 tests and the NEXT mmap-ing code
# path SIGSEGVs — measured r4: maps climbed 26k -> 63.6k and the process died
# within one sample of the ceiling, deterministically at the same test. This
# is ALSO what r3 blamed on the AOT-cache deserializer (the cache read path
# mmaps too; whoever allocates at the ceiling dies). Raise the limit for the
# suite when we can (root in this container); warn loudly otherwise.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _limit = int(_f.read())
    if _limit < 262144:
        try:
            with open("/proc/sys/vm/max_map_count", "w") as _f:
                _f.write("1048576")
        except OSError:
            import warnings

            warnings.warn(
                f"vm.max_map_count={_limit} is too low for a full-suite run "
                "(XLA:CPU JIT mappings accumulate past it and SIGSEGV); "
                "run `sysctl -w vm.max_map_count=1048576` or split the "
                "suite into multiple pytest invocations."
            )
except OSError:
    pass

import hashlib  # noqa: E402

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")


# Persistent compile cache: OPT-IN for tests (SDSLAM_TEST_CACHE=1).
#
# The XLA:CPU AOT executable deserializer in this jaxlib is unsafe on this
# host: EVERY persistent-cache read warns 'machine type used for
# compilation doesn't match the machine type for execution' (the compile
# target records pseudo-features like +prefer-no-scatter plus avx512/amx
# variants the loader then can't match), and reads intermittently SIGSEGV
# inside compilation_cache.get_executable_and_time — reproduced r3 even
# with a cache directory freshly keyed by this host's /proc/cpuinfo flags,
# i.e. same-host entries are not reliably loadable either. A crashed suite
# is worse than a slow one, so correctness wins by default; local dev
# loops that accept the risk can export SDSLAM_TEST_CACHE=1 for fast warm
# reruns (~15 min vs ~40-70 min cold).
if ON_CARD:
    pass  # the calling process owns the cache settings
elif os.environ.get("SDSLAM_TEST_CACHE") == "1":
    try:
        with open("/proc/cpuinfo") as f:
            flags_line = next(
                (l for l in f if l.startswith("flags")), "generic"
            )
    except OSError:
        flags_line = "generic"
    digest = hashlib.sha256(flags_line.encode()).hexdigest()[:10]
    from sdslam_tpu.utils.compile_cache import DEFAULT_DIR

    jax.config.update(
        "jax_compilation_cache_dir", f"{DEFAULT_DIR}_cpu_{digest}"
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
else:
    # HARD kill switch: even if some code path sets a cache dir mid-run
    # (jax.config is process-global), the enable flag keeps
    # _is_cache_enabled() false — r4 saw two full-suite SIGSEGVs under the
    # cache code path at the same suite position.
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "heavy: long-running e2e/distributed tests "
        "(fast tier: pytest -m 'not heavy')",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skipped on the CPU, run on the card by "
        "`python chip_smoke.py`",
    )


@pytest.fixture
def gpu_device():
    """The CUDA device a `gpu`-marked test runs on. Decided here, at test
    time, never at import: xdist workers must all collect the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA device (run `python chip_smoke.py` on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _no_cache_arming(request):
    """Tripwire: the persistent compile cache must stay un-armed for the
    whole suite unless SDSLAM_TEST_CACHE=1 (the XLA:CPU AOT cache is
    unsafe on this host — see the note above). Catches any test that
    arms it process-globally (e.g. an in-process cli.main call)."""
    yield
    if not ON_CARD and os.environ.get("SDSLAM_TEST_CACHE") != "1":
        assert not jax.config.jax_compilation_cache_dir, (
            f"{request.node.nodeid} armed the persistent compile cache: "
            f"{jax.config.jax_compilation_cache_dir!r}"
        )


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Keep the unmeasured north-star metric VISIBLE (VERDICT r3 weak #7):
    the TUM/EuRoC ATE regressions skip silently when no sequence is on
    disk; print a loud line so every run records the gap and the one
    command that closes it."""
    tum = os.environ.get(
        "SDSLAM_TUM_ROOT", "/root/datasets/rgbd_dataset_freiburg1_xyz"
    )
    euroc = os.environ.get("SDSLAM_EUROC_ROOT", "/root/datasets/MH_01_easy")
    missing = [p for p in (tum, euroc) if not os.path.isdir(p)]
    if missing:
        terminalreporter.section("north-star dataset regressions")
        for p in missing:
            terminalreporter.write_line(
                f"NOT MEASURED: real-dataset ATE (no sequence at {p})"
            )
        terminalreporter.write_line(
            "To activate: place/point SDSLAM_TUM_ROOT / SDSLAM_EUROC_ROOT "
            "at real sequences, then run "
            "`python scripts/check_datasets.py` for the exact pytest command."
        )
