"""Golden oracle: reference-exact engine (NumPy + C++ inner loops).

Serves two roles:
1. Executable specification of the reference's semantics (mode="exact":
   float accumulation, per-paint-call phase wraps, all quirks preserved).
2. Golden source for device parity tests (mode="parity": the
   order-independent formulations the device engine reproduces bit-for-bit).
"""

from . import modules, instruments, engine  # noqa: F401
from .engine import Voice, render_blocks, render_to_s16  # noqa: F401
