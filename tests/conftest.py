"""Test configuration: JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (JAX_PLATFORMS=cpu unless the environment says
otherwise). XLA_FLAGS must be in the environment before the CPU client
initializes (lazily, on first use) to get 8 virtual devices for the
sharding tests. Kernels run there in Pallas interpret mode, called with
interpret=True by their tests; tests marked `gpu` need the card and skip
on the CPU (python chip_smoke.py runs them on a GPU).

The suite also enables JAX's persistent compilation cache
(zang_tpu.platform.enable_compile_cache: JAX_COMPILATION_CACHE_DIR, or
.jax_cache/ in the checkout): XLA:CPU compiles dominate suite cost.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# repo root on sys.path so `import zang_tpu` works without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zang_tpu.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_collection_modifyitems(config, items):
    """Data-driven slow marks: tests/slow_tests.txt (generated by
    tools/suite_costs.py from a measured warm --durations=0 run) lists the
    nodeids whose call time makes them full-suite-only; `-m "not slow"` is
    the fast profile. Files with blanket pytestmark slow marks (goldens,
    fuzz) keep those too."""
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(here)
    path = os.path.join(here, "slow_tests.txt")
    try:
        with open(path) as f:
            slow = {ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")}
    except OSError:
        config.issue_config_time_warning(
            pytest.PytestConfigWarning(
                f"{path} missing — data-driven slow marks inactive; "
                "regenerate with tools/suite_costs.py --slowlist"),
            stacklevel=2)
        return
    for item in items:
        # slow_tests.txt records repo-root-relative nodeids; item.nodeid
        # is relative to the INVOCATION rootdir, so running from inside
        # tests/ would silently miss every entry — normalize instead
        rel = os.path.relpath(str(item.fspath), repo_root).replace(
            os.sep, "/")
        key = rel + "::" + item.nodeid.split("::", 1)[1] if (
            "::" in item.nodeid) else rel
        if key in slow:
            item.add_marker(pytest.mark.slow)
