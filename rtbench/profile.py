"""A traced window, reduced in memory to what the per-layer metrics read.

A traced run wraps its frames in `torch.profiler` (CPU and CUDA
activities) and each frame in the span FRAME_SPAN.  `reduce` keeps, from
the profiler's raw events, the frame spans, the card's kernels and copies,
and the host events of the thread that rendered, as (name, start, end)
tuples in seconds from the first frame's start; no trace file is written.
Which kernels are the port's own is read off the kernel library the
program built (`build/kernels/libraytrace-*.so` of the checkout): a
kernel's name is the port's when its identifier appears there as a
mangled name's part.
"""

import bisect
import re
from dataclasses import dataclass, field
from pathlib import Path

FRAME_SPAN = "rtbench.frame"
LIBRARY_GLOB = "build/kernels/libraytrace-*.so"


@dataclass
class RankTrace:
    """One process's traced window."""

    frames: list                                  # (start, end)
    device: list                                  # (name, start, end, kind)
    host: list = field(default_factory=list)      # (name, start, end)

    @property
    def window(self) -> tuple:
        return self.frames[0][0], self.frames[-1][1]


@dataclass
class Trace:
    """The traced window of every rank (rank 0 first) and the identifiers
    of the port's kernels."""

    ranks: list
    port_ids: frozenset

    def port_kernel(self, name: str) -> bool:
        return kernel_identifier(name) in self.port_ids


def kernel_identifier(name: str) -> str:
    """The unqualified function name of a demangled kernel name:
    `void (anonymous namespace)::cull_kernel<1>(float const*, ...)` ->
    `cull_kernel`."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^(void|__global__ void)\s+", "", s.strip())
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    s = re.sub(r"<.*>$", "", s)
    return s.split("::")[-1].strip()


def port_kernel_ids(names, root: Path) -> frozenset:
    """Those of the kernel names whose identifier the port's kernel
    libraries under `root` hold, as a length-prefixed (mangled) name."""
    blobs = [p.read_bytes() for p in sorted(Path(root).glob(LIBRARY_GLOB))]
    out = set()
    for ident in {kernel_identifier(n) for n in names}:
        token = f"{len(ident)}{ident}".encode()
        if ident and any(token in b for b in blobs):
            out.add(ident)
    return frozenset(out)


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    start = int(ev.start_us() * 1000)
    return start if which == "start" else start + int(ev.duration_us() * 1000)


def _device_kind(ev):
    """'kernel' or 'copy' for an activity on the card; None for other
    events (the frame span and other annotations projected onto the
    card's timeline)."""
    name = ev.name()
    at = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") \
        else ""
    if (name == FRAME_SPAN or "annotation" in at
            or getattr(ev, "is_user_annotation", lambda: False)()):
        return None
    if "memcpy" in at or "memset" in at or name.startswith(("Memcpy",
                                                            "Memset")):
        return "copy"
    if at and "kernel" not in at:
        return None
    return "kernel"


def reduce(prof) -> RankTrace:
    """The frame spans, the card's activity and the rendering thread's host
    events of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    frames = sorted((_ns(e, "start"), _ns(e, "end"), e.start_thread_id())
                    for e in events if e.name() == FRAME_SPAN
                    and e.device_type() == DeviceType.CPU)
    if not frames:
        raise RuntimeError("the traced window holds no frame span")
    t0 = frames[0][0]
    thread = frames[0][2]

    def sec(ns):
        return (ns - t0) * 1e-9

    device, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() != FRAME_SPAN and e.start_thread_id() == thread:
                host.append((e.name(), sec(_ns(e, "start")),
                             sec(_ns(e, "end"))))
            continue
        kind = _device_kind(e)
        if kind is not None:
            device.append((e.name(), sec(_ns(e, "start")),
                           sec(_ns(e, "end")), kind))
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return RankTrace([(sec(a), sec(b)) for a, b, _ in frames], device, host)


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def busy_s(rank: RankTrace) -> float:
    """Seconds of the window in which a kernel or a copy ran on the card."""
    lo, hi = rank.window
    return covered([(s, e) for _, s, e, _ in rank.device], lo, hi)


def idle_gaps(rank: RankTrace) -> list:
    """(start, end) of the window's stretches with nothing on the card."""
    lo, hi = rank.window
    gaps, t = [], lo
    for a, b in merged([(s, e) for _, s, e, _ in rank.device], lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_activity(rank: RankTrace, t: float, starts=None) -> str:
    """The innermost host event active at time t; the frame span where no
    torch op was (the host's own Python and numpy work).  starts: the host
    events' start times, where the caller asks many times."""
    if starts is None:
        starts = [h[1] for h in rank.host]
    i = bisect.bisect_right(starts, t)
    best = None
    for name, s, e in reversed(rank.host[max(0, i - 4096):i]):
        if e >= t:
            best = name
            break
    if best is not None:
        return best
    if any(a <= t <= b for a, b in rank.frames):
        return FRAME_SPAN
    return "between frames"


def breakdown(rank: RankTrace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, [name, seconds] each, the largest first."""
    ops = {}
    for name, s, e, _ in rank.device:
        ops[name] = ops.get(name, 0.0) + (e - s)
    gaps = {}
    starts = [h[1] for h in rank.host]
    for a, b in idle_gaps(rank):
        name = host_activity(rank, 0.5 * (a + b), starts)
        gaps[name] = gaps.get(name, 0.0) + (b - a)

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
