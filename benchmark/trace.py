"""Host spans and the device trace of a measured window.

``Spans`` records the benchmark's own spans around its calls into the
port's layers (batch, train step, rollout chunk), on the clock that
``torch.profiler`` stamps its events with (``time.time_ns``). ``DeviceTrace``
runs the profiler over the whole window, CUDA activity alone, and keeps the
device operations (kernels, copies, sets) as (start, end, name); the
readers under ``metrics/`` and the ``breakdown`` of the result line are
worked out from it.
"""

from __future__ import annotations

import contextlib
import time

from benchmark import yardstick


class Spans:
    """(name, start_ns, end_ns) of the host's spans, in memory until the
    run ends."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))


class DeviceTrace:
    """The device operations of one window, from ``torch.profiler`` with
    CUDA activity. ``start``/``stop`` bracket the window; the window's
    bounds are the host's clock at those points (the window ends after a
    synchronize, so every operation it issued lies inside)."""

    def __init__(self, export: str | None = None):
        self.export = export  # where to write the profiler's Chrome trace as well
        self.ops: list[tuple[int, int, str]] = []
        self.lo = self.hi = 0
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.lo = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.hi = time.time_ns()
        self._prof.__exit__(None, None, None)
        if self.export:
            self._prof.export_chrome_trace(self.export)
        cuda = torch.autograd.DeviceType.CUDA
        self.ops = [(e.start_ns(), e.end_ns(), e.name()) for e in self._prof.profiler.kineto_results.events()
                    if e.device_type() == cuda]
        self._prof = None
        if not self.ops:
            raise RuntimeError("the profiler recorded no device operation in the window")

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return yardstick.interval_union_ns(((s, e) for s, e, _ in self.ops), self.lo, self.hi) / 1e9

    def kernel_seconds(self, match) -> float:
        """Summed durations of the operations whose name ``match`` accepts."""
        return sum(e - s for s, e, name in self.ops if match(name)) / 1e9

    def kernel_count(self, match) -> int:
        """Launches of the operations whose name ``match`` accepts."""
        return sum(1 for _, _, name in self.ops if match(name))

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the idle
        gaps of the device by the innermost host span open at each gap's
        middle ("host" where none is)."""
        by_op: dict[str, int] = {}
        for s, e, name in self.ops:
            by_op[name] = by_op.get(name, 0) + (e - s)
        by_span: dict[str, int] = {}
        nested = sorted(spans.items, key=lambda sp: (sp[1], -sp[2]))  # outer spans first
        stack: list[tuple[str, int, int]] = []
        i = 0
        for lo, hi in yardstick.idle_gaps(((s, e) for s, e, _ in self.ops), self.lo, self.hi):
            mid = (lo + hi) // 2
            while i < len(nested) and nested[i][1] <= mid:
                while stack and stack[-1][2] <= nested[i][1]:
                    stack.pop()
                stack.append(nested[i])
                i += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            key = stack[-1][0] if stack else "host"
            by_span[key] = by_span.get(key, 0) + (hi - lo)
        ranked = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
