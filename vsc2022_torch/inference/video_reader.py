"""Host-side video decode at a fixed fps (the port's own copy of
``vsc2022_tpu/inference/video_reader.py``).

ffmpeg streams raw RGB24 frames over a pipe: no temp files and no PNG
round trip (the reference dumps PNGs to a temp dir and reloads them with
PIL; reference: vsc/baseline/video_reader/ffmpeg_video_reader.py:29-54),
so frames land in numpy buffers ready for one packed host-to-device
copy.

Readers yield (start_s, end_s, uint8 [H, W, 3]) like the reference's
(start, end, PIL.Image) contract. ffmpeg is not bundled; without it the
reader raises a clear error, and tests use stub executables or
ArrayVideoReader.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from abc import ABC, abstractmethod
from typing import Iterable, Optional, Tuple

import numpy as np

FrameT = Tuple[float, float, np.ndarray]


class VideoReader(ABC):
    """(reference: vsc/baseline/video_reader/video_reader.py:14-31)"""

    def __init__(self, video_path: str, required_fps: float) -> None:
        self.video_path = video_path
        self.required_fps = required_fps

    @property
    @abstractmethod
    def fps(self) -> Optional[float]:
        ...

    @abstractmethod
    def frames(self) -> Iterable[FrameT]:
        """Yield (start_time_s, end_time_s, rgb_uint8_frame)."""
        ...


def _probe_dims(video_path: str, ffprobe_path: str) -> Tuple[int, int]:
    out = subprocess.check_output(
        [
            ffprobe_path, "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=width,height", "-of", "json", video_path,
        ]
    )
    stream = json.loads(out)["streams"][0]
    return int(stream["width"]), int(stream["height"])


class FFMpegVideoReader(VideoReader):
    """Streaming rawvideo pipe decode at a fixed sampling fps.

    Frame i sampled at ``required_fps`` covers (i / required_fps,
    (i+1) / required_fps) seconds. The reference stamps a 1 s span on
    every frame whatever --fps is, right only at fps=1 (reference:
    vsc/baseline/video_reader/ffmpeg_video_reader.py:47-54);
    ``reference_compat_timestamps=True`` reproduces that bit for bit. At
    fps=1 the two are the same.
    """

    def __init__(
        self,
        video_path: str,
        required_fps: float,
        ffmpeg_path: str = "ffmpeg",
        ffprobe_path: Optional[str] = None,
        reference_compat_timestamps: bool = False,
    ):
        super().__init__(video_path, required_fps)
        self.frame_span = 1.0 if reference_compat_timestamps else 1.0 / required_fps
        self.ffmpeg_path = ffmpeg_path
        self.ffprobe_path = ffprobe_path or (
            ffmpeg_path[:-6] + "ffprobe" if ffmpeg_path.endswith("ffmpeg")
            else "ffprobe"
        )
        if shutil.which(self.ffmpeg_path) is None:
            raise RuntimeError(
                f"ffmpeg binary not found at '{self.ffmpeg_path}'. Video "
                "decode requires ffmpeg on the host; install it or use a "
                "different VideoReader (precomputed frames / ArrayVideoReader)."
            )

    @property
    def fps(self) -> Optional[float]:
        return None

    def frames(self) -> Iterable[FrameT]:
        width, height = _probe_dims(self.video_path, self.ffprobe_path)
        frame_bytes = width * height * 3
        proc = subprocess.Popen(
            [
                self.ffmpeg_path, "-nostdin", "-i", self.video_path,
                "-vf", f"fps={self.required_fps:f}",
                "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        try:
            i = 0
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                frame = np.frombuffer(buf, dtype=np.uint8).reshape(height, width, 3)
                yield (i * self.frame_span, (i + 1) * self.frame_span, frame)
                i += 1
        finally:
            proc.stdout.close()
            proc.wait()


class ArrayVideoReader(VideoReader):
    """In-memory reader for tests and precomputed-frame pipelines."""

    def __init__(self, frames: np.ndarray, required_fps: float = 1.0):
        super().__init__("<array>", required_fps)
        self._frames = frames

    @property
    def fps(self) -> Optional[float]:
        return self.required_fps

    def frames(self) -> Iterable[FrameT]:
        for i, frame in enumerate(self._frames):
            yield (
                i / self.required_fps,
                (i + 1) / self.required_fps,
                np.asarray(frame, dtype=np.uint8),
            )
