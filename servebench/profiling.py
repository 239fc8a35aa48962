"""The traced run's device view: ``torch.profiler`` over the mix's span.

Only CUDA activity is recorded (no host op events). The per-launch cost of
the device trace still slows the eager host loop inside the span, so the
span lies after the window has closed (``traffic.profile_span``), and no
window metric is read while it runs. ``summarize`` turns the device events
into the busy seconds (the union of kernel, copy and set intervals), the
length of the span, device seconds by kernel name, and the longest idle
gaps, each named by the operations on either side of it. The events' list goes
nowhere else: nothing is written to disk.
"""
from __future__ import annotations

import collections
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch



def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void wna16_kernel<4, 64, true>(Args)`` -> ``wna16_kernel``."""
    n = re.sub(r"^void\s+", "", name.strip())
    n = n.replace("(anonymous namespace)::", "")
    n = n.split("(")[0]
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    n = "".join(out).strip()
    return n.split("::")[-1] or name[:60]


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device event."""
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = e.time_range
        if tr.end > tr.start:
            out.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    return out


class Span:
    """One profiled span: ``start()`` and ``stop()`` at step boundaries.
    On the card it records CUDA activity; on the CPU (the benchmark's own
    tests) host activity, which holds no device event."""

    def __init__(self, sync: Callable[[], None], on_card: bool = True):
        self.sync = sync
        self.activities = [torch.profiler.ProfilerActivity.CUDA if on_card
                           else torch.profiler.ProfilerActivity.CPU]
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.sync()
        t = time.perf_counter()
        self.prof = torch.profiler.profile(activities=self.activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.start_cost = self.t0 - t

    def stop(self) -> None:
        self.sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_cost = time.perf_counter() - self.t1

    def warm_up(self) -> float:
        """Start and stop the profiler once, empty: its first start in a
        process takes 6-9 s on an H100, which belongs in set-up and not at
        the span's opening. Returns the seconds it took."""
        t = time.perf_counter()
        self.start()
        self.stop()
        return time.perf_counter() - t

    def summarize(self, top: int = 10) -> Dict:
        ev = sorted(_device_events(self.prof), key=lambda e: e[1])
        by_name: Dict[str, float] = collections.Counter()
        busy, cur_s, cur_e = 0.0, None, None
        gaps = []
        prev = None
        for name, s, e in ev:
            short = short_name(name)
            by_name[short] += e - s
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, f"{prev} -> {short}"))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev = short
        if cur_e is not None:
            busy += cur_e - cur_s
        gaps.sort(key=lambda g: -g[0])
        agg: Dict[str, float] = collections.Counter()
        for dur, label in gaps:
            agg[label] += dur
        return {
            "busy_s": busy,
            "window_s": self.t1 - self.t0,
            "events": len(ev),
            "kernel_s": dict(by_name),
            "device_ops": [[n, s] for n, s in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(agg.items(), key=lambda kv: -kv[1])[:top]],
        }


def kernel_seconds(summary: Optional[Dict], name: str) -> float:
    """Device seconds of the kernels called ``name`` in the span."""
    if not summary:
        return 0.0
    return sum(s for n, s in summary["kernel_s"].items() if n == name)
