"""Process set-up shared by the CLIs, bench.py and chip_smoke.py.

JAX picks its platform from JAX_PLATFORMS as usual (JAX_PLATFORMS=cpu for
the test suite). This module keeps JAX's persistent compilation cache in
one place and reports the device a measurement ran on.
"""

import os
import subprocess
import sys

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there and no
    other location is set here. Otherwise the cache is .jax_cache/ at the
    root of the checkout (listed in .gitignore), one fixed path, so a
    later process in the same checkout finds what an earlier one compiled.
    Call before the first compile."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(tool: str) -> dict:
    """Exit non-zero unless JAX's default device is a GPU; otherwise print
    the device (JAX's view and nvidia-smi's name and power limit) and
    return {"platform", "kind", "count"}. Measurements never fall back to
    the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"{tool}: no GPU found (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(1)
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    print(f"# device: {info['kind']} x{info['count']} "
          "(nvidia-smi name, power.limit below)")
    print(nvidia_smi(), flush=True)
    return info
