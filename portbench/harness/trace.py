"""The device trace of a traced run, and its reduction.

The traced run profiles a fixed, short count of steps inside its window
with torch.profiler (CPU and CUDA activities), inside one span named
WINDOW_SPAN that ends in a synchronize. The trace is exported as a chrome
trace under TMPDIR, read back here and deleted. Times are microseconds on
the profiler's clock, which host and device events share.
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "portbench.window"


def union(intervals):
    """Merged, sorted (start, end) intervals of the given ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Trace:
    """The spans, device operations and launches of one chrome trace."""

    def __init__(self, events):
        self.spans = []  # (name, start, end): record_function spans
        self.device = []  # (name, start, end, correlation)
        self.launch_ts = {}  # correlation -> host start of its launch call
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat", ""), float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat == "user_annotation":
                self.spans.append((e["name"], ts, end))
            elif cat in DEVICE_CATS:
                self.device.append((e["name"], ts, end, args.get("correlation")))
            elif cat in LAUNCH_CATS and args.get("correlation") is not None:
                self.launch_ts[args["correlation"]] = ts
        window = [s for s in self.spans if s[0] == WINDOW_SPAN]
        self.window = (window[0][1], window[0][2]) if window else None

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def spans_of(self, name):
        return [s for s in self.spans if s[0] == name]

    def span_us(self, name) -> float:
        """Summed host duration of the spans of this name."""
        return sum(e - s for _, s, e in self.spans_of(name))

    def nested_us(self, inner, outer) -> float:
        """Summed duration of `inner` spans that lie inside an `outer` span."""
        outs = self.spans_of(outer)
        return sum(e - s for _, s, e in self.spans_of(inner)
                   if any(a <= s and e <= b for _, a, b in outs))

    def busy(self):
        """Merged device intervals inside the window: when a kernel, copy or
        set ran on the device (their union, not their sum)."""
        if not self.window:
            return []
        a, b = self.window
        return union((max(s, a), min(e, b)) for _, s, e, _ in self.device if e > a and s < b)

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_us(self, match) -> float:
        """Summed device time of the operations whose name match() accepts."""
        return sum(e - s for n, s, e, _ in self.device if match(n))

    def device_us_launched_in(self, name) -> float:
        """Summed device time of the operations launched (by their launch
        call's correlation) while the host was inside a span of `name`."""
        spans = sorted((s, e) for _, s, e in self.spans_of(name))
        total = 0.0
        for _, s, e, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is not None and any(a <= t <= b for a, b in spans):
                total += e - s
        return total

    def host_span_at(self, t) -> str:
        """The innermost span (the window's aside) the host was in at t."""
        inside = [(e - s, n) for n, s, e in self.spans if s <= t <= e and n != WINDOW_SPAN]
        return min(inside)[1] if inside else "harness"

    def idle_gaps(self):
        """(start, end) of each stretch of the window with no device work."""
        if not self.window:
            return []
        a, b = self.window
        gaps, t = [], a
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        return gaps

    def breakdown(self, top=10):
        """The contract's `breakdown`: the device operations that took most
        time, and the longest idle gaps, each named by the span the host
        was in at its middle; seconds."""
        by_op = {}
        for n, s, e, _ in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:200], us * 1e-6] for n, us in ops],
            "idle_gaps": [[self.host_span_at((s + e) / 2), (e - s) * 1e-6] for s, e in gaps],
        }


def export(prof, tag) -> str:
    """Write prof's chrome trace under TMPDIR; returns its path."""
    path = os.path.join(tempfile.gettempdir(), f"portbench-{tag}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
