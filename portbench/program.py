"""The port's own spans (mbb_emcee_tpu_torch.utils.profiling) against the
traced run's device timeline: where the card idles, by the program step
the host was in.

The program records its spans only while torch's profiler records, so in
the traced window alone, and on its own clock (time.perf_counter_ns). The
harness's run / summary / derived spans stand on both clocks: in each
request's `spans` (perf_counter seconds) and in the trace (microseconds).
The median difference of their midpoints puts the program's spans on the
trace's clock. Each idle interval of each card is then split exactly, by overlap,
among the innermost program spans open on the host during it; each piece
goes to the layer of its span's root (one root per top-level program
call), and what no span covers stays unattributed. A program without the
recorder, or a run without the trace, has nothing to read: every function
here then returns None.
"""

from __future__ import annotations

import statistics

from portbench.trace import _union

# The layer of a root span, by its name's prefix (PERF.md's layers).
LAYERS = (("mbb.fit.", "fit protocol"), ("mbb.results.", "results"),
          ("mbb.derived.", "derived posteriors"), ("mbb.kernel.", "kernels"))
# The harness's spans that stand on both clocks.
HARNESS = ("run", "summary", "derived")


def recorded():
    """The program's spans, or None where it recorded none."""
    try:
        from mbb_emcee_tpu_torch.utils.profiling import recorded as spans
    except ImportError:          # a program without the recorder
        return None
    return spans() or None


def layer_of(name):
    for prefix, layer in LAYERS:
        if name.startswith(prefix):
            return layer
    return None


def clock_offset(ctx):
    """(offset, largest residual), in microseconds, of the trace's clock
    against perf_counter over the harness's spans: trace time = perf_counter
    seconds x 1e6 + offset. Each span gives the difference at its midpoint,
    where the annotation's lag behind the harness's clock at the start
    cancels its lead at the end. None where the two lists do not pair
    up."""
    host = [(n, a, b) for a, b, n in ctx.timeline.host_spans.spans
            if n in HARNESS]
    mine = sorted((a, n, b) for r in ctx.requests for n, a, b in r.spans
                  if n in HARNESS)
    if not mine or len(host) != len(mine) \
            or any(h[0] != m[1] for h, m in zip(host, mine)):
        return None
    diffs = [0.5 * (ha + hb) - 0.5e6 * (ma + mb)
             for (_, ha, hb), (ma, _, mb) in zip(host, mine)]
    off = statistics.median(diffs)
    return off, max(abs(d - off) for d in diffs)


def _innermost(spans, off):
    """[(a, b, i)]: the stretches of the trace's clock (us) in which span i
    is the innermost open one, in time order."""
    events = []
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        events.append((s.start_ns * 1e-3 + off, 1, i))
        events.append((s.end_ns * 1e-3 + off, 0, -i))
    events.sort()
    out, stack, t_prev = [], [], None
    for t, opening, i in events:
        if stack and t > t_prev:
            out.append((t_prev, t, stack[-1]))
        if opening:
            stack.append(i)
        elif -i in stack:
            stack.remove(-i)
        t_prev = t
    return out


def _idle(tl, card):
    """The card's idle intervals (us) inside the window."""
    edges = [tl.t0]
    for a, b in _union([(a, b) for a, b, _ in tl.device[card]]):
        edges += [a, b]
    edges.append(tl.t1)
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def _overlap(xs, ys):
    """Yield (a, b, label) of every overlap of the sorted disjoint
    intervals xs [(a, b)] with the sorted disjoint labelled ys
    [(a, b, label)]."""
    j = 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            lo, hi = max(a, ys[k][0]), min(b, ys[k][1])
            if hi > lo:
                yield lo, hi, ys[k][2]
            k += 1


def split(ctx):
    """The traced window's idle time per completed request, in ms averaged
    over the cell's cards: `layers` {layer: ms}, `steps` {span name: ms}
    (by the innermost span), `unattributed` ms, `idle` ms in all; the idle
    ms inside the harness's spans (`harness_idle`) and the share of it a
    program span covers (`harness_attributed`); `residual_us`, the clock
    alignment's largest residual; `spans` per request. None where there is
    nothing to read."""
    if ctx.timeline is None:
        return None
    cached = getattr(ctx, "_program_split", None)
    if cached is not None:
        return cached
    spans, done = recorded(), sum(1 for r in ctx.requests if r.error is None)
    clock = clock_offset(ctx)
    if spans is None or clock is None or done == 0:
        return None
    off, residual = clock
    inner = _innermost(spans, off)
    harness = [(a, b, n) for a, b, n in ctx.timeline.host_spans.spans
               if n in HARNESS]
    layers, steps = {}, {}
    idle = harness_idle = covered = 0.0
    for card in ctx.cards:
        gaps = _idle(ctx.timeline, card)
        idle += sum(b - a for a, b in gaps)
        for a, b, i in _overlap(gaps, inner):
            s = spans[i]
            layer = layer_of(spans[s.root].name)
            layers[layer] = layers.get(layer, 0.0) + (b - a)
            steps[s.name] = steps.get(s.name, 0.0) + (b - a)
        in_harness = [(a, b) for a, b, _ in _overlap(gaps, harness)]
        harness_idle += sum(b - a for a, b in in_harness)
        covered += sum(b - a for a, b, _ in _overlap(in_harness, inner))
    scale = 1e-3 / (done * len(ctx.cards))
    out = {"layers": {k: v * scale for k, v in layers.items()},
           "steps": {k: v * scale for k, v in steps.items()},
           "idle": idle * scale,
           "unattributed": (idle - sum(layers.values())) * scale,
           "harness_idle": harness_idle * scale,
           "harness_attributed": covered / harness_idle if harness_idle
           else None,
           "residual_us": residual,
           "spans": len(spans) / done}
    ctx._program_split = out
    return out


def idle_ms(ctx, fitter, layer):
    """A layer's idle ms per completed request in a cell of `fitter`."""
    if ctx.cfg["fitter"] != fitter:
        return None
    got = split(ctx)
    if got is None:
        return None
    return got["layers"].get(layer, 0.0)


def d2h_mb(ctx, fitter):
    """Megabytes (1e6 bytes) the program's spans counted as copied from
    the card to the host, per completed request."""
    if ctx.cfg["fitter"] != fitter:
        return None
    spans = recorded()
    done = sum(1 for r in ctx.requests if r.error is None)
    if spans is None or done == 0:
        return None
    return sum(s.counters.get("d2h_bytes", 0) for s in spans) / done * 1e-6
