"""Screenshot + recording output, mirroring src/render_output/
screenshot_recorder.rs semantics: ``screenshotN.png`` auto-numbering and
``recordingN/`` per-frame capture directories driven by a fixed frame length.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from .png import write_png


class ScreenshotRecorder:
    def __init__(self, output_dir: str | pathlib.Path = "."):
        self.output_dir = pathlib.Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._recording_dir: Optional[pathlib.Path] = None
        self._frame = 0

    def screenshot(self, rgb: np.ndarray) -> pathlib.Path:
        """Write screenshotN.png with the first free N."""
        n = 0
        while (self.output_dir / f"screenshot{n}.png").exists():
            n += 1
        path = self.output_dir / f"screenshot{n}.png"
        write_png(path, rgb)
        return path

    def start_recording(self) -> pathlib.Path:
        n = 0
        while (self.output_dir / f"recording{n}").exists():
            n += 1
        self._recording_dir = self.output_dir / f"recording{n}"
        self._recording_dir.mkdir()
        self._frame = 0
        return self._recording_dir

    @property
    def is_recording(self) -> bool:
        return self._recording_dir is not None

    def capture_frame(self, rgb: np.ndarray) -> Optional[pathlib.Path]:
        if self._recording_dir is None:
            return None
        path = self._recording_dir / f"{self._frame:06d}.png"
        write_png(path, rgb)
        self._frame += 1
        return path

    def stop_recording(self) -> Optional[pathlib.Path]:
        out, self._recording_dir = self._recording_dir, None
        return out
