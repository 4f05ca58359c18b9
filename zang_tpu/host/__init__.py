"""Host layer: song parsing, instruments, example programs, offline rendering.

The device-rendering counterpart of the reference's examples/ directory (SDL host, song
parser, reusable instruments — SURVEY.md §2e). Interactive SDL hosting is
replaced by offline/CLI rendering; the event-to-tensor compiler serves both.
"""
