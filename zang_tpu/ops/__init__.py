"""Device ops: the DSP module library, re-architected for XLA/Pallas.

Design (see SURVEY.md §7): modules are pure functions over [..., time]
float32 tensors with small state pytrees. Per-sample recurrences become:
- fixed-point u32 phase counters + parallel prefix sums (oscillators),
- host-compiled gather programs over f32-exact paint tables (envelope,
  portamento, gate, curve),
- associative affine scans (SVF filter, pink noise),
- chunk-sequential scans only where feedback demands it (delay loops).
"""

from . import scan  # noqa: F401
from . import segprog  # noqa: F401
from . import oscillators  # noqa: F401
from . import control  # noqa: F401
from . import filters  # noqa: F401
from . import noise  # noqa: F401
from . import effects  # noqa: F401
from . import delay  # noqa: F401
from . import sampler  # noqa: F401
