"""Frame input state with binary record and replay (mirrors
``mrt.runtime.input``).

The reference polls a gamepad into an ``InputCollection`` and its
interactive scene writes each frame's input to a file so an animation
can be replayed.  Here a frame's input is a small struct, recorded and
replayed in the same binary layout, so dynamic scenes
(``scenes/playground.py``) stay reproducible.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List


@dataclasses.dataclass
class InputCollection:
    """One frame of controller state."""
    stick_x: float = 0.0
    stick_y: float = 0.0
    cam_x: float = 0.0
    cam_z: float = 0.0
    button_a: bool = False
    button_b: bool = False
    button_z: bool = False

    _FMT = "<ffff???"

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.stick_x, self.stick_y,
                           self.cam_x, self.cam_z, self.button_a,
                           self.button_b, self.button_z)

    @classmethod
    def unpack(cls, data: bytes) -> "InputCollection":
        return cls(*struct.unpack(cls._FMT, data))

    @classmethod
    def size(cls) -> int:
        return struct.calcsize(cls._FMT)


class InputRecorder:
    """Accumulates frames and writes them out."""

    def __init__(self):
        self.frames: List[InputCollection] = []

    def record(self, inp: InputCollection):
        self.frames.append(inp)

    def save(self, path):
        with open(path, "wb") as f:
            for inp in self.frames:
                f.write(inp.pack())


class InputReplay:
    """Plays a recording back: frame(i) is the recorded frame i, and the
    last one past the end."""

    def __init__(self, path):
        size = InputCollection.size()
        self.frames = []
        with open(path, "rb") as f:
            while True:
                chunk = f.read(size)
                if len(chunk) < size:
                    break
                self.frames.append(InputCollection.unpack(chunk))

    def frame(self, index) -> InputCollection:
        if not self.frames:
            return InputCollection()
        return self.frames[min(index, len(self.frames) - 1)]
