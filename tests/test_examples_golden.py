"""Whole-graph golden parity for EVERY example config.

The reference treats its 19 examples as the acceptance suite (SURVEY.md §4);
here each config in host/examples.py renders twice — through the device engine
and through the sequential oracle twins (backend="oracle": oracle/examples.py
walker-driven instruments, oracle/script.py bytecode interpreter) — and the
difference must stay under the FIDELITY.md budget (RMS < -90 dBFS).

All tests are slow-marked: the full sweep is ~5 min of sequential oracle
rendering on the 1-core box. The fast profile keeps the direct per-module
parity tests (test_parity.py, test_ops_effects.py) as its coverage.
"""

import numpy as np
import pytest

from zang_tpu.host.examples import EXAMPLES

BUDGET_DBFS = -90.0

# short but feature-covering windows: each window spans at least one full
# note cycle (attack..release) of its example, plus any post-fx tail
SECONDS = {
    "play": 2.0,
    "envelope": 2.0,
    "vibrato": 2.0,
    "curve": 2.0,
    "laser": 2.0,
    "subsong": 3.0,
    "two": 2.5,
    "arpeggiator": 2.0,
    "polyphony": 2.0,
    "stereo": 2.0,
    "detuned": 2.0,
    "portamento": 2.0,
    "mouse": 2.0,
    "fmsynth": 2.0,
    "sampler": 2.0,
    "polyphony2": 2.0,
    "delay": 2.5,
    "script": 2.0,
    "script_runtime": 2.0,
    "song": 4.0,
}


def rms_dbfs(d: np.ndarray) -> float:
    d = d.astype(np.float64)
    return 20.0 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


# Long-horizon sweep: the stateful configs, rendered 15-30 s at a
# NON-default chunk size. Catches what the short windows can't: delay
# tails crossing many chunk seams, sampler multi-loop wrap, curve/track
# cursors deep into a song, dozens of retriggers, and cross-chunk state
# drift (the engine's chunking must not change the audio at all for
# noise-free configs — white noise is chunk-keyed by design, so the
# detuned config asserts parity at the alt chunk but not invariance).
LONG_SECONDS = {
    "delay": 15.0,
    "detuned": 15.0,
    "sampler": 15.0,
    "subsong": 15.0,
    "portamento": 15.0,
    "script": 15.0,
    "song": 20.0,
}
ALT_CHUNK = 8192
ALT_SONG_CHUNK = 32768
# detuned is doubly chunk-coupled, BY DESIGN, so it runs at the default
# chunk (long-DURATION coverage only): (a) its white noise is chunk-keyed
# like every engine noise site; (b) its oracle twin consumes a warble
# trajectory reconstructed with standalone chunked ops — the engine
# computes the same ops fused inside the render scan, and XLA:CPU's
# fusion choices at other chunk sizes reassociate at ulp level, which the
# freq path phase-accumulates into tens of dB (FIDELITY.md; the 4 Hz SVF
# itself is covered by the direct filter parity tests).
DEFAULT_CHUNK_ONLY = {"detuned"}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(LONG_SECONDS))
def test_example_golden_long_horizon(name):
    import zang_tpu.host.examples as ex

    secs = LONG_SECONDS[name]
    if name in DEFAULT_CHUNK_ONLY:
        engine, sr = EXAMPLES[name](seconds=secs)
        oracle, sr2 = EXAMPLES[name](seconds=secs, backend="oracle")
        chunk_used = ex.DEFAULT_CHUNK
    else:
        engine_default, _sr = EXAMPLES[name](seconds=secs)
        saved = (ex.DEFAULT_CHUNK, ex.SONG_CHUNK)
        try:
            ex.DEFAULT_CHUNK = ALT_CHUNK
            ex.SONG_CHUNK = ALT_SONG_CHUNK
            engine, sr = EXAMPLES[name](seconds=secs)
            oracle, sr2 = EXAMPLES[name](seconds=secs, backend="oracle")
        finally:
            ex.DEFAULT_CHUNK, ex.SONG_CHUNK = saved
        chunk_used = ALT_CHUNK
    assert float(sr) == float(sr2)
    a = np.asarray(engine)
    b = np.asarray(oracle)
    assert a.shape == b.shape
    dev = rms_dbfs(a - b)
    ref = rms_dbfs(b)
    assert ref > -60.0, f"oracle render suspiciously quiet ({ref:.1f} dBFS)"
    assert dev < BUDGET_DBFS, (
        f"{name}: long-horizon engine vs oracle RMS {dev:.1f} dBFS "
        f"(budget {BUDGET_DBFS}, chunk {chunk_used})")
    if name not in DEFAULT_CHUNK_ONLY:
        inv = rms_dbfs(a - np.asarray(engine_default))
        assert inv < -120.0, (
            f"{name}: chunking changed the audio ({inv:.1f} dBFS RMS "
            f"between chunk {ALT_CHUNK} and the default)")


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_golden(name):
    assert name in SECONDS, f"add a golden window for new example {name!r}"
    secs = SECONDS[name]
    engine, sr = EXAMPLES[name](seconds=secs)
    oracle, sr2 = EXAMPLES[name](seconds=secs, backend="oracle")
    assert float(sr) == float(sr2)
    a = np.asarray(engine)
    b = np.asarray(oracle)
    assert a.shape == b.shape
    dev = rms_dbfs(a - b)
    ref = rms_dbfs(b)
    assert ref > -60.0, f"oracle render suspiciously quiet ({ref:.1f} dBFS)"
    assert dev < BUDGET_DBFS, (
        f"{name}: engine vs oracle RMS {dev:.1f} dBFS (budget {BUDGET_DBFS})"
    )
