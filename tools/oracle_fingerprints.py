"""Pin the oracle's behavior: SHA-256 fingerprints of every example's
oracle render, committed as tests/oracle_fingerprints.json.

The golden sweep (tests/test_examples_golden.py) compares ENGINE vs
ORACLE — a relative check. An accidental edit that shifts both sides the
same way (an oracle twin tweaked while "fixing" an engine kernel, a
shared constant changed) passes the sweep silently while quietly
redefining the reference semantics. The manifest breaks that symmetry:
the oracle's exact output bytes are pinned, so any oracle behavior change
fails tests/test_oracle_fp.py loudly until the manifest is deliberately
regenerated (and the diff reviewed) with:

    python tools/oracle_fingerprints.py --update
    python tools/oracle_fingerprints.py --check      # what the test does

Determinism scope: oracle renders are sequential numpy f32 (fixed seeds,
threefry tapes injected), bit-stable across runs on one machine and
across machines for pure-numpy configs. The `detuned` twin deliberately
consumes an ENGINE-derived warble trajectory (oracle/examples.py
detuned_warble — XLA:CPU-computed), so its bytes may legitimately change
across jax/jaxlib upgrades: regenerate the manifest when upgrading and
note it in the journal. Window lengths are pinned HERE (not shared with
the golden sweep) so sweep tuning can't silently re-window the pins.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Pin the SAME environment the test suite renders in (tests/conftest.py):
# XLA:CPU with 8 virtual devices. The detuned twin consumes engine-computed
# trajectories, so fingerprints taken on another backend (a GPU) differ at
# ulp level and the pins would flap.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from zang_tpu.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

MANIFEST = os.path.join(REPO, "tests", "oracle_fingerprints.json")

# render windows (seconds) — fixed forever unless the manifest is bumped
WINDOW = {
    "play": 2.0, "envelope": 2.0, "vibrato": 2.0, "curve": 2.0,
    "laser": 2.0, "subsong": 3.0, "two": 2.5, "arpeggiator": 2.0,
    "polyphony": 2.0, "stereo": 2.0, "detuned": 2.0, "portamento": 2.0,
    "mouse": 2.0, "fmsynth": 2.0, "sampler": 2.0, "polyphony2": 2.0,
    "delay": 2.5, "script": 2.0, "script_runtime": 2.0, "song": 4.0,
}


def fingerprint(name: str) -> str:
    """SHA-256 of the oracle render's exact f32 bytes (shape prefixed, so
    a silent shape change can't collide with a content change)."""
    import numpy as np

    from zang_tpu.host.examples import EXAMPLES

    audio, sr = EXAMPLES[name](seconds=WINDOW[name], backend="oracle")
    a = np.ascontiguousarray(np.asarray(audio, dtype=np.float32))
    h = hashlib.sha256()
    h.update(repr((a.shape, float(sr))).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def load_manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--update", action="store_true",
                   help="(re)render everything and rewrite the manifest")
    g.add_argument("--check", action="store_true",
                   help="re-render and compare against the manifest")
    ap.add_argument("--only", action="append", metavar="NAME",
                    help="restrict to specific example(s)")
    args = ap.parse_args(argv)

    from zang_tpu.host.examples import EXAMPLES

    missing = sorted(set(EXAMPLES) - set(WINDOW))
    if missing:
        print(f"add WINDOW entries for new examples: {missing}")
        return 1
    unknown = sorted(set(args.only or ()) - set(WINDOW))
    if unknown:
        print(f"unknown example name(s): {unknown} "
              f"(choose from: {sorted(WINDOW)})")
        return 1
    names = args.only or sorted(WINDOW)

    if args.update:
        entries = dict(load_manifest()) if (
            args.only and os.path.exists(MANIFEST)) else {}
        for name in names:
            entries[name] = fingerprint(name)
            print(f"{name}: {entries[name][:16]}…")
        with open(MANIFEST, "w") as f:
            json.dump(entries, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {MANIFEST} ({len(entries)} entries)")
        return 0

    manifest = load_manifest()
    bad = []
    for name in names:
        got = fingerprint(name)
        ok = manifest.get(name) == got
        print(f"{name}: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
    if bad:
        print(f"oracle drift (or platform numerics shift) in: {bad} — "
              "review the change, then --update and commit")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
