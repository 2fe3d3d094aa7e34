"""Progress / run statistics: a copy of `rust_raytrace_tpu/utils/progress.py`
(the port imports nothing of the JAX package).  `RayCaster.walk_rays` and
`Engine.render(progress=...)` feed it per render (`update_wavefront`) and,
for a render in several slabs, per slab.

The reference keeps a named-stat registry of `Time` / `Count` values fed from
worker threads over an mpsc channel, renders a live terminal dashboard
(alternate screen via crossterm, per-thread current-row lines, ETA,
cumulative Mrays/s — progress.rs:69-142), and prints a final report whose
headline is million rays per second (progress.rs:157-162).

Here stats are fed per WAVEFRONT or per SLAB (the units of progress in a
batched renderer) rather than per row; the per-thread rows become per-wave
live-ray rows.  Two terminal modes:
  - dashboard (default on a TTY): alternate screen, multi-row live view
    with ETA — the crossterm UI rebuilt on raw ANSI escapes;
  - line: a single overwriting status line (non-TTY-safe).
"""

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Union


@dataclass
class ProgressStat:
    """Time (seconds) or Count stat (reference ProgressStat, progress.rs:8-55)."""

    kind: str                 # "time" | "count"
    value: float = 0.0

    def add(self, v: float):
        self.value += v


@dataclass
class ProgressCtx:
    """Accumulating run context (reference ProgressCtx, progress.rs:57-90)."""

    width: int = 0
    height: int = 0
    enable_io: bool = False
    dashboard: bool = False      # alternate-screen UI (progress.rs:69-142)
    start_time: float = field(default_factory=time.perf_counter)
    stop_time: float = 0.0
    runtimes: Dict[str, ProgressStat] = field(default_factory=dict)
    finished_pixels: int = 0
    total_rays: int = 0
    _alt_screen: bool = field(default=False, repr=False)

    def _stat(self, name: str, kind: str) -> ProgressStat:
        if name not in self.runtimes:
            self.runtimes[name] = ProgressStat(kind)
        return self.runtimes[name]

    def update(self, pixels: int, runstats: Dict[str, Union[float, int]],
               kinds: Dict[str, str] = None):
        """Merge one progress report (reference update, progress.rs:95-142)."""
        elapsed = time.perf_counter() - self.start_time
        self.finished_pixels += pixels
        if "Rays" in runstats:
            self.total_rays += int(runstats["Rays"])
        for k, v in runstats.items():
            kind = (kinds or {}).get(k, "count")
            self._stat(k, kind).add(v)

        if self.enable_io:
            if self.dashboard:
                self._draw_dashboard(elapsed)
            else:
                total = max(1, self.width * self.height)
                frac = self.finished_pixels / total
                rate = self.total_rays / max(elapsed, 1e-9) / 1e6
                sys.stdout.write(
                    "\r\x1b[2K"
                    f"Run time: {int(elapsed) // 60}:{int(elapsed) % 60:02d} "
                    f"Completed: {self.finished_pixels}/{total} "
                    f"{frac * 100.0:.2f}%  "
                    f"Rays: {self.total_rays / 1e6:.3f}M {rate:.3f} Mrays/s")
                sys.stdout.flush()

    def _draw_dashboard(self, elapsed: float):
        """Alternate-screen multi-row live view (progress.rs:95-142): runtime,
        ETA, pixel progress, cumulative Mrays/s, and per-wave live-ray rows
        (the per-worker current-row lines of the threaded reference)."""
        w = sys.stdout
        if not self._alt_screen:
            w.write("\x1b[?1049h\x1b[?25l")     # alt screen + hide cursor
            self._alt_screen = True
        total = max(1, self.width * self.height)
        frac = min(self.finished_pixels / total, 1.0)
        rate = self.total_rays / max(elapsed, 1e-9) / 1e6
        eta = (elapsed / frac - elapsed) if frac > 1e-9 else float("inf")
        eta_s = ("--:--" if eta == float("inf")
                 else f"{int(eta) // 60}:{int(eta) % 60:02d}")
        bar_n = 40
        filled = int(frac * bar_n)

        w.write("\x1b[H\x1b[2J")                # home + clear
        w.write(f"Run time: {int(elapsed) // 60}:{int(elapsed) % 60:02d}"
                f"    ETA: {eta_s}\r\n")
        w.write(f"[{'#' * filled}{'.' * (bar_n - filled)}] "
                f"{frac * 100.0:6.2f}%\r\n")
        w.write(f"Pixels:   {self.finished_pixels}/{total}\r\n")
        w.write(f"Rays:     {self.total_rays / 1e6:.3f}M total, "
                f"{rate:.3f} Mrays/s\r\n")
        waves = sorted((k, s.value) for k, s in self.runtimes.items()
                       if k.startswith("Wave") and k.endswith("Rays"))
        if waves:
            w.write("\r\n")
            for k, v in waves:
                idx = k[len("Wave"):-len("Rays")]
                w.write(f"  wave {idx}: {int(v):>12d} rays\r\n")
        w.flush()

    def update_wavefront(self, result):
        """Adapter for RenderResult (per-render progress report)."""
        self.update(result.image.shape[0] * result.image.shape[1],
                    {"Rays": result.rays_traced,
                     "Render": result.seconds},
                    kinds={"Rays": "count", "Render": "time"})
        for i, n in enumerate(result.wave_rays):
            self._stat(f"Wave{i}Rays", "count").add(int(n))

    def finish(self):
        self.stop_time = time.perf_counter()
        if self._alt_screen:
            # restore the main screen (progress.rs:144-155)
            sys.stdout.write("\x1b[?1049l\x1b[?25h")
            sys.stdout.flush()
            self._alt_screen = False
        elif self.enable_io:
            sys.stdout.write("\n")
            sys.stdout.flush()

    def print_stats(self, out=print):
        """Final report (reference print_stats, progress.rs:157-184)."""
        if not self.stop_time:
            self.finish()
        secs = max(self.stop_time - self.start_time, 1e-9)
        out(f"Processed {self.total_rays / 1e6:.3f} million rays in "
            f"{secs:.3f} seconds. {self.total_rays / secs / 1e6:.3f} "
            f"million rays/s")
        times = sorted((k, s.value) for k, s in self.runtimes.items()
                       if s.kind == "time")
        counts = sorted((k, s.value) for k, s in self.runtimes.items()
                        if s.kind == "count")
        for k, v in times:
            out(f"{k}: {int(v)}.{int(v * 1000) % 1000:03d}")
        out("")
        for k, v in counts:
            out(f"{k}: {int(v)}")


def create_ctx(width: int, height: int, enable_io: bool = False,
               dashboard: bool = None) -> ProgressCtx:
    """Reference create_ctx (progress.rs:69-90).  dashboard=None picks the
    alternate-screen UI on a TTY and the single status line otherwise."""
    if dashboard is None:
        dashboard = enable_io and sys.stdout.isatty()
    return ProgressCtx(width=width, height=height, enable_io=enable_io,
                       dashboard=dashboard)
