"""Live-reload script hosting: the runtime.zig replacement.

The reference ships a bytecode interpreter for live reload
(src/zangscript/runtime.zig) that had hardcoded Delay(11025) and an
unimplemented track_call (runtime.zig:292,508-514), and had bit-rotted out
of the build. Here, re-jitting on reload is strictly better: the same
compiled-performance path serves both ahead-of-time and live use, honors
declared delay lengths, and supports track calls.

LiveScript mirrors the host behavior around reload (examples/example.zig:
401-422): a failed compile keeps the previous instrument playing-disabled
("muted") with the error preserved for display; a successful reload swaps
the instrument in.
"""

import os
from typing import Optional

from .compile import CompiledScript, compile_script
from .errors import ScriptError
from .jax_backend import ScriptInstrument


class LiveScript:
    def __init__(self, path: str, module_name: str, param_map=None):
        self.path = path
        self.module_name = module_name
        self.param_map = param_map
        self.compiled: Optional[CompiledScript] = None
        self.instrument: Optional[ScriptInstrument] = None
        self.error: Optional[ScriptError] = None
        self._mtime = 0.0
        self.reload()

    @property
    def ok(self) -> bool:
        return self.error is None and self.instrument is not None

    def reload(self) -> bool:
        """(Re)compile the script file. Returns True on success; on failure
        keeps the previous instrument and stores the error."""
        try:
            with open(self.path) as f:
                contents = f.read()
            compiled = compile_script(contents, filename=self.path)
            instrument = ScriptInstrument(compiled, self.module_name, self.param_map)
        except (ScriptError, OSError, KeyError) as e:
            self.error = e if isinstance(e, ScriptError) else ScriptError(
                __import__("zang_tpu.script.errors", fromlist=["Source"]).Source(
                    self.path, ""), None, str(e))
            return False
        self.compiled = compiled
        self.instrument = instrument
        self.error = None
        self._mtime = os.path.getmtime(self.path)
        return True

    def maybe_reload(self) -> bool:
        """Reload if the file changed on disk (the watch_script.sh flow)."""
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return False
        if mtime != self._mtime:
            self._mtime = mtime
            return self.reload()
        return False
