"""The traced run's device timeline: torch.profiler over the measured
window, exported as a Chrome trace and reduced to each card's busy
intervals, the kernels by name, and the idle gaps labelled by what the
host was doing.

Device activity is every kernel, copy and fill the profiler saw on a card
(categories kernel, gpu_memcpy, gpu_memset). The window is the
"portbench.window" annotation the harness opens and closes around the
measured requests.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
TOP = 10


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof):
    """Stop the profiler and reduce its trace (a Chrome trace written to
    and removed from TMPDIR)."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return Timeline(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name, n=96):
    name = name.split("(")[0].replace("void ", "").strip()
    return name[:n]


class _Disjoint:
    """Disjoint labelled intervals, searchable by time."""

    def __init__(self, spans):
        top = []
        for a, b, name in sorted(spans):
            if top and a < top[-1][1]:
                continue            # nested in the previous top-level span
            top.append((a, b, name))
        self.starts = [a for a, _, _ in top]
        self.spans = top

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t < self.spans[i][1]:
            return self.spans[i][2]
        return None


class Timeline:
    """Busy intervals per card within the window, kernel times by name,
    and the host's spans; times in microseconds of the trace's clock."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = collections.defaultdict(list)    # card -> [(a, b, name)]
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                a = float(e["ts"])
                b = a + float(e["dur"])
                if b <= self.t0 or a >= self.t1:
                    continue
                card = int(e.get("args", {}).get("device", 0))
                self.device[card].append((max(a, self.t0), min(b, self.t1),
                                          e["name"]))
        self.host_spans = _Disjoint([
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"].split(".", 1)[1]) for e in xs
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("portbench.")
            and e["name"] not in (WINDOW, "portbench.request")])
        self.host_ops = _Disjoint([
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime",
                                            "cuda_driver")])

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self, card):
        return sum(b - a for a, b in
                   _union([(a, b) for a, b, _ in self.device[card]])) * 1e-6

    def kernel_s(self, card, needle):
        """Seconds of the kernels on `card` whose name holds `needle`."""
        return sum(b - a for a, b, n in self.device[card] if needle in n) \
            * 1e-6

    def device_ops(self, cards):
        tot = collections.Counter()
        for c in cards:
            for a, b, n in self.device[c]:
                tot[_short(n)] += (b - a) * 1e-6
        return [[n, s] for n, s in tot.most_common(TOP)]

    def idle_gaps(self, cards):
        """Idle seconds per card, summed by what the host was doing at
        each gap's midpoint (the harness span / the host operation),
        averaged over `cards`."""
        tot = collections.Counter()
        for c in cards:
            edges = [self.t0]
            for a, b in _union([(a, b) for a, b, _ in self.device[c]]):
                edges += [a, b]
            edges.append(self.t1)
            for a, b in zip(edges[0::2], edges[1::2]):
                if b <= a:
                    continue
                mid = 0.5 * (a + b)
                label = (f"{self.host_spans.at(mid) or 'between'}/"
                         f"{self.host_ops.at(mid) or 'python'}")
                tot[label] += (b - a) * 1e-6 / len(cards)
        return [[n, s] for n, s in tot.most_common(TOP)]
