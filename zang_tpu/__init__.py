"""zang_tpu — an accelerator-native modular audio synthesis framework.

A ground-up rebuild of the capabilities of dbandstra/zang (a Zig real-time
audio synthesis library) in JAX/XLA/Pallas, running on an NVIDIA GPU:

- Modules are pure functions ``(state, params) -> (state, audio)`` over
  ``[..., time]`` tensors instead of imperative per-sample paint loops
  (reference: src/zang.zig:1-41, module protocol src/modules/SineOsc.zig:8-31).
- Note events compile host-side into dense segment tables ("events become
  data"); the Trigger/ImpulseQueue span machinery (src/zang/trigger.zig,
  src/zang/notes.zig) runs on host and produces tensors the device consumes.
- Per-sample recurrences (SVF filter, envelopes, delays) are reformulated as
  chunked affine scans / gather programs that keep the time axis parallel.
- Polyphony is a leading voice axis; mixdown is a sum (shardable with psum
  over a device mesh).

Subpackages:
  core      host-side event system, timeline compiler, mixdown, WAV, pitch
  ops       device ops for the 13 DSP modules, scans, GPU kernels
  graph     module protocol, voices, offline renderer
  oracle    NumPy/C++ reference engine with exact zang semantics (golden)
  parallel  device-mesh sharding (voice/batch axes)
  script    zangscript compiler (tokenizer/parser/codegen/JAX backend)
  host      song parser, instruments, live sessions, example programs
  serve     batch serving: multi-song scheduling, shared compiles
"""

__version__ = "0.2.0"

from . import core  # noqa: F401,E402

# Lazy top-level conveniences: `zang_tpu.Performance`, `zang_tpu.LiveSession`
# etc. resolve on first use without importing jax-heavy modules at package
# import time.
_LAZY = {
    "SongEvent": ("zang_tpu.core.notes", "SongEvent"),
    "compile_timelines": ("zang_tpu.core.timeline", "compile_timelines"),
    "Performance": ("zang_tpu.graph.render", "Performance"),
    "render_performance": ("zang_tpu.graph.render", "render_performance"),
    "LiveSession": ("zang_tpu.host.live", "LiveSession"),
    "compile_script": ("zang_tpu.script", "compile_script"),
    "read_wav": ("zang_tpu.core.wav", "read_wav"),
    "write_wav_s16": ("zang_tpu.core.wav", "write_wav_s16"),
    "deviation_dbfs": ("zang_tpu.graph.fidelity", "deviation_dbfs"),
    "BatchRenderer": ("zang_tpu.serve.batch", "BatchRenderer"),
    "RenderJob": ("zang_tpu.serve.batch", "RenderJob"),
    "LiveFleet": ("zang_tpu.serve.live", "LiveFleet"),
    "LiveServer": ("zang_tpu.serve.server", "LiveServer"),
    "LiveClient": ("zang_tpu.serve.server", "LiveClient"),
    "MultiInstrumentServer": ("zang_tpu.serve.server",
                              "MultiInstrumentServer"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'zang_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
