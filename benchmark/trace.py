"""Reduction of a ``torch.profiler`` trace of the window to what the per-layer
metrics read.

Device events (kernels, copies, fills) carry the correlation id of the host
call that launched them. A span of the port (a ``record_function`` range)
owns every device event launched while it was open on any thread: the
main thread waits inside ``backward()`` while autograd's device thread
launches the backward, so launch time, not the thread, decides. Times are
in seconds.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

_ACTIVITY = {"kernel": "device", "gpu_memcpy": "device", "gpu_memset": "device",
             "gpu_user_annotation": "span_on_device",
             "user_annotation": "span", "cpu_op": "op"}
SHORT_GAP_NS = 20_000      # gaps shorter than this are summed, not labelled
LABELLED_GAPS = 2000       # the longest gaps labelled by the host's activity


def _merge(intervals: list[tuple[int, int]]) -> np.ndarray:
    if not intervals:
        return np.zeros((0, 2), dtype=np.int64)
    iv = np.array(sorted(intervals), dtype=np.int64)
    out = [iv[0].tolist()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64)


def _kind(e) -> str:
    """device, runtime (a launch on the host), span, op, a span's copy on
    the device's timeline, or other. Older
    PyTorch events have no activity type: the device type, the annotation
    flag and the CUDA API's names tell them apart."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        kind = activity()
        # every CUDA API call on the host is a launch's runtime record
        return _ACTIVITY.get(kind) or ("runtime" if kind.startswith("cuda_") else "other")
    if str(e.device_type()).endswith("CUDA"):
        annotation = getattr(e, "is_user_annotation", None)
        return "span_on_device" if annotation is not None and annotation() else "device"
    name = e.name()
    if name.startswith(("cuda", "cu")):
        return "runtime"
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None:
        return "span" if annotation() else "op"
    return "op" if "::" in name else "span"


class Trace:
    """``device``: [(name, start_ns, dur_ns, launch_ns or -1)]; ``host``:
    [(name, start_ns, dur_ns, is_span)] of the host's operations and spans."""

    def __init__(self, device: list, host: list, window_s: float):
        self.device = device
        self.host = host
        self.window_s = window_s
        self.busy = _merge([(s, s + d) for _, s, d, _ in device])
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) / 1e9 if len(device) else 0.0
        spans = defaultdict(list)
        for name, s, d, is_span in host:
            if is_span:
                spans[name].append((s, s + d))
        self.spans = {k: _merge(v) for k, v in spans.items()}
        self._launch = np.array([x[3] for x in device], dtype=np.int64)
        self._dur = np.array([x[2] for x in device], dtype=np.int64)

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        events = prof.profiler.kineto_results.events()
        kinds = [_kind(e) for e in events]
        launches, device, host = {}, [], []
        for e, kind in zip(events, kinds):
            if kind == "runtime":
                launches[e.correlation_id()] = e.start_ns()
            elif kind in ("span", "op"):
                host.append((e.name(), e.start_ns(), e.duration_ns(), kind == "span"))
        # the spans also appear on the device's timeline: not device work
        span_names = {h[0] for h in host if h[3]}
        for e, kind in zip(events, kinds):
            if kind == "device" and e.name() not in span_names:
                corr = e.correlation_id()
                if corr not in launches:
                    corr = e.linked_correlation_id()
                device.append((e.name(), e.start_ns(), e.duration_ns(), launches.get(corr, -1)))
        return cls(device, host, window_s)

    def span_device_s(self, *names: str) -> float | None:
        """Device seconds of the events launched inside any of the spans;
        None when no span of these names was open in the window or the
        device recorded nothing."""
        iv = [self.spans[n] for n in names if n in self.spans]
        if not iv or not self.device:
            return None
        merged = _merge([tuple(x) for a in iv for x in a.tolist()])
        idx = np.searchsorted(merged[:, 0], self._launch, side="right") - 1
        inside = (idx >= 0) & (self._launch >= 0)
        inside[inside] &= self._launch[inside] < merged[idx[inside], 1]
        return float(self._dur[inside].sum()) / 1e9

    def last_launches(self, substring: str, count: int = 1) -> list[float]:
        """Device seconds of the last ``count`` events whose name holds
        ``substring``, in launch order."""
        hits = sorted((x[3], x[2]) for x in self.device if substring in x[0])
        return [d / 1e9 for _, d in hits[-count:]]

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(int)
        for name, _, d, _ in self.device:
            by[name[:160]] += d
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time between busy stretches, summed by the innermost
        host operation or span open when the gap began."""
        if len(self.busy) < 2:
            return []
        starts, ends = self.busy[1:, 0], self.busy[:-1, 1]
        gaps = sorted(zip((starts - ends).tolist(), ends.tolist()), reverse=True)
        host = sorted(self.host, key=lambda h: h[1])
        host_start = [h[1] for h in host]
        by = defaultdict(int)
        for n, (length, at) in enumerate(gaps):
            if length < SHORT_GAP_NS or n >= LABELLED_GAPS:
                by["gaps under 20 us or past the longest 2000"] += length
                continue
            i = bisect.bisect_right(host_start, at) - 1
            label = "host outside any operation"
            for j in range(i, max(i - 400, -1), -1):
                if host[j][1] + host[j][2] >= at:
                    label = host[j][0]
                    break
            by[label[:160]] += length
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
