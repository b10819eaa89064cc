"""Scene .conf loaders.
Counterpart of gravit_tpu/scene/readers/conf.py, copied (numpy only).

Two formats exist in the reference:
  1. geometry lists (data/geom/*.conf): comment header then lines of
     `path lox loy loz hix hiy hiz` — each file is one domain; consumed by
     the ply/obj apps.
  2. the full ConfigFileLoader format (data/README.conf): width/height,
     view angle, camera/focus/up, render + schedule type, sample rate,
     brick topology, data file — the reference's loader is bit-rotted
     (ConfigFileLoader marked "TODO update to new context",
     CMakeLists.txt:77-80); this one is live.

Both loaders raise ConfError naming the file, the field being parsed and
the line/token position on malformed or truncated input (the reference's
loader would segfault or mis-read silently; 'brittle, all arguments in
order' is its own README's wording).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Tuple


class ConfError(ValueError):
    """Malformed .conf: carries file, field and position context."""


@dataclasses.dataclass
class GeomEntry:
    path: str
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]


def read_geom_conf(path: str) -> List[GeomEntry]:
    """Format 1: lines of `file lox loy loz hix hiy hiz` (bunny.conf)."""
    base = pathlib.Path(path).parent
    out = []
    for lineno, line in enumerate(
            pathlib.Path(path).read_text().splitlines(), start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 7:
            raise ConfError(
                f"{path}:{lineno}: geometry entry needs "
                f"`file lox loy loz hix hiy hiz` (7 tokens), got "
                f"{len(parts)}: {line!r}")
        try:
            nums = [float(x) for x in parts[1:7]]
        except ValueError as e:
            raise ConfError(
                f"{path}:{lineno}: bad bounds value in {line!r}: {e}"
            ) from None
        out.append(GeomEntry(str(base / parts[0]),
                             tuple(nums[:3]), tuple(nums[3:])))
    return out


@dataclasses.dataclass
class RenderConfig:
    width: int = 512
    height: int = 512
    view_angle: float = 45.0         # degrees, as the .conf files store it
    camera: Tuple = (0.0, 0.0, 0.0)
    focus: Tuple = (0.0, 0.0, -1.0)
    up: Tuple = (0.0, 1.0, 0.0)
    render_type: str = "Volume"      # Volume | Surface | Manta
    schedule_type: str = "Image"
    sample_rate: float = 1.0
    topology: Tuple[int, int, int] = (1, 1, 1)
    datafile: str = ""


class _Cursor:
    """Positional token walk with named-field errors: every .conf token
    remembers its source line so a truncated or malformed file reports
    `file:line: field ...` instead of a bare IndexError."""

    def __init__(self, path: str):
        self.path = path
        self.toks: List[str] = []
        self.lines: List[int] = []
        for lineno, line in enumerate(
                pathlib.Path(path).read_text().splitlines(), start=1):
            line = line.split("#")[0].strip()
            for tok in line.split():
                self.toks.append(tok)
                self.lines.append(lineno)
        self.i = 0

    def take(self, field: str, conv, count: int):
        if self.i + count > len(self.toks):
            where = (f"line {self.lines[-1]}" if self.toks
                     else "empty file")
            raise ConfError(
                f"{self.path}: truncated at {where}: field '{field}' "
                f"needs {count} more token(s), "
                f"{len(self.toks) - self.i} left")
        vals = []
        for k in range(count):
            tok = self.toks[self.i + k]
            try:
                vals.append(conv(tok))
            except ValueError:
                raise ConfError(
                    f"{self.path}:{self.lines[self.i + k]}: field "
                    f"'{field}' expects {conv.__name__}, got {tok!r}"
                ) from None
        self.i += count
        return vals[0] if count == 1 else tuple(vals)

    def remaining(self) -> bool:
        return self.i < len(self.toks)


def read_render_conf(path: str) -> RenderConfig:
    """Format 2 (README.conf order; 'brittle, all arguments in order')."""
    t = _Cursor(path)
    c = RenderConfig()
    c.width = t.take("width", int, 1)
    c.height = t.take("height", int, 1)
    c.view_angle = t.take("view_angle", float, 1)
    c.camera = t.take("camera", float, 3)
    c.focus = t.take("focus", float, 3)
    c.up = t.take("up", float, 3)
    c.render_type = t.take("render_type", str, 1)
    c.schedule_type = t.take("schedule_type", str, 1)
    c.sample_rate = t.take("sample_rate", float, 1)
    c.topology = t.take("topology", int, 3)
    if t.remaining():
        c.datafile = t.take("datafile", str, 1)
    return c
