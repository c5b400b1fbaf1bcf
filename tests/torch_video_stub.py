"""Stub ``ffmpeg`` / ``ffprobe`` executables for the port's extraction
tests (there is no ffmpeg here). A "video" file is a JSON recipe,
``{"w": W, "h": H, "frames": [[seed, j], ...]}``; the stub ffprobe prints
its size and the stub ffmpeg writes one textured RGB24 frame per entry,
a function of (seed, j) alone, so a query that lists a reference's
entries is an exact copy of those frames."""

import json
import os
import stat
import sys
from pathlib import Path

FFPROBE = """#!{python}
import json, sys
spec = json.load(open(sys.argv[-1]))
print(json.dumps({{"streams": [{{"width": spec["w"], "height": spec["h"]}}]}}))
"""

FFMPEG = """#!{python}
import json, random, sys
spec = json.load(open(sys.argv[sys.argv.index("-i") + 1]))
h, w = spec["h"], spec["w"]
bh, bw = -(-h // 4), -(-w // 4)
for seed, j in spec["frames"]:
    # 4x4 blocks of random colours (pure Python: no numpy import per video).
    px = random.Random(seed * 1000 + j).randbytes(bh * bw * 3)
    rows = []
    for r in range(bh):
        row = b"".join(px[3 * (r * bw + c):3 * (r * bw + c) + 3] * 4 for c in range(bw))
        rows += [row[:3 * w]] * 4
    sys.stdout.buffer.write(b"".join(rows[:h]))
"""


def write_tools(directory) -> str:
    """Write the stubs into ``directory``; returns the ffmpeg path (the
    reader finds ffprobe beside it)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name, text in (("ffprobe", FFPROBE), ("ffmpeg", FFMPEG)):
        path = directory / name
        path.write_text(text.format(python=sys.executable))
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return str(directory / "ffmpeg")


def write_video(path, frames, w=64, h=48) -> None:
    """A recipe "video" of the (seed, j) ``frames``."""
    Path(path).write_text(json.dumps({"w": w, "h": h, "frames": [list(f) for f in frames]}))
