"""Span: a half-open [start, end) sample range within a mix block.

Reference: src/zang/basics.zig:3-11. In this build spans only exist on the
host, where the event system splits blocks at note boundaries; the device
consumes dense per-sample tensors instead.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class Span:
    start: int
    end: int

    def __len__(self) -> int:
        return self.end - self.start

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(f"bad span [{self.start}, {self.end})")
