"""Where the command's output goes while it is timed: in memory, never
to the disk, keeping only what the output check reads.

:class:`GlyphRows` takes ``sparkfft``'s stdout: its header line, then rows
of ``width + 2`` characters and a newline; it counts the rows, keeps the
ones drawn for the check, and holds the pass's text (the strings the
command wrote, not joined) until the next pass.
"""

from __future__ import annotations

import numpy as np


class GlyphRows:
    """``sparkfft``'s stdout for one pass at a time.  ``begin(rows)``
    names the row indices to keep; after the pass, ``header``, ``rows``
    (how many), ``kept`` (index -> row text) and ``malformed`` (a reason,
    or None) describe what it printed."""

    def __init__(self, width: int):
        self.row_chars = width + 2
        self.begin(np.zeros(0, dtype=np.int64))

    def begin(self, keep: np.ndarray) -> None:
        self.keep = np.sort(np.asarray(keep, dtype=np.int64))
        self.header: str | None = None
        self._head: list[str] = []
        self.pos = 0  # characters after the header line
        self.kept: dict[int, str] = {}
        self.blocks: list[str] = []
        self.malformed: str | None = None

    def write(self, s: str) -> int:
        n = len(s)
        if self.header is None:
            cut = s.find("\n")
            if cut < 0:
                self._head.append(s)
                return n
            self._head.append(s[:cut])
            self.header = "".join(self._head)
            s = s[cut + 1 :]
        step = self.row_chars + 1
        self.blocks.append(s)
        lo = self.pos
        hi = lo + len(s)
        if len(self.keep):
            a = np.searchsorted(self.keep, -(-lo // step))
            b = np.searchsorted(self.keep, (hi - 1) // step + 1)
            for r in self.keep[a:b]:
                at = int(r) * step - lo
                if at + self.row_chars <= len(s):
                    self.kept[int(r)] = s[at : at + self.row_chars]
                else:
                    self.malformed = f"row {int(r)} split across writes"
        self.pos = hi
        return n

    def flush(self) -> None:
        pass

    @property
    def rows(self) -> int:
        return self.pos // (self.row_chars + 1)

    def finish(self) -> None:
        if self.pos % (self.row_chars + 1):
            self.malformed = f"{self.pos} characters of rows is not a whole number of {self.row_chars}-character rows"


def glyph_levels(text: str, width: int) -> "np.ndarray | None":
    """Rows of ``sparkfft`` glyphs (each framed, each ended by a newline)
    as an ``(R, width)`` array of levels 0-8, or None where the text is not
    such rows."""
    from sdrbench.reference.chain import FRAME, GLYPHS

    code = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
    step = width + 3
    if len(code) % step:
        return None
    code = code.reshape(-1, step)
    if not (np.all(code[:, 0] == ord(FRAME)) and np.all(code[:, -2] == ord(FRAME)) and np.all(code[:, -1] == 10)):
        return None
    lut = np.full(max(map(ord, GLYPHS)) + 1, 255, dtype=np.uint8)
    for i, g in enumerate(GLYPHS):
        lut[ord(g)] = i
    body = code[:, 1:-2]
    if body.max(initial=0) >= len(lut):
        return None
    levels = lut[body]
    return None if np.any(levels == 255) else levels.astype(np.int64)
