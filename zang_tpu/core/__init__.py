"""Host-side core: event system, note timeline compiler, mixdown, WAV, pitch.

These are the parts of the reference that are control-plane, not DSP: they run
on the host in Python and compile note events into dense tensors the device
consumes (reference: src/zang/notes.zig, src/zang/trigger.zig).
"""

from .notes import (  # noqa: F401
    Impulse,
    IdGenerator,
    ImpulsesAndParamses,
    ImpulseQueue,
    SongEvent,
    NoteTracker,
    PolyphonyDispatcher,
)
from .trigger import Trigger, NoteSpanResult  # noqa: F401
from .span import Span  # noqa: F401
from .curves import CurveNode, PaintCurve  # noqa: F401
