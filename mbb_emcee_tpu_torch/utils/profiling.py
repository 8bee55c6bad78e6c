"""Tracing hooks and step-rate timing.

Torch twin of mbb_emcee_tpu/utils/profiling.py:

  * `trace(dir, device=None)` -- context manager around torch.profiler; on
    a CUDA device it records the host's operators and the card's kernels
    (the fused sampling kernels among them) and writes one Chrome trace
    (`*.pt.trace.json`) into `dir`, which opens in Perfetto
    (ui.perfetto.dev) or chrome://tracing. Wired to both MBB CLIs as
    --profile-dir. The JAX package writes jax.profiler's TensorBoard
    format instead.
  * `span(name, **attrs)`, `count(name, n)`, `note(**attrs)`,
    `recorded()` -- the port's own spans (`mbb.fit.*`, `mbb.kernel.*`,
    `mbb.results.*`, `mbb.derived.*`), their counters (`d2h_bytes`, the
    bytes a copy to the host moves; `sed_evals`, the SED evaluations a
    kernel launch computes) and the attributes known only inside them (K3's
    `group` and `cluster`, the layout it launched). They record only while
    torch's profiler records (trace() above, or any torch.profiler
    session): each span is then also a `record_function` annotation of the
    Chrome trace, beside the kernels it launched. Otherwise `span` returns
    one shared no-op context and `count` and `note` return at once.
  * `StepTimer` -- wall-clock walker-steps/sec meter with the JAX
    package's phase / rate / report output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Capture a torch.profiler trace of the block into log_dir (no-op if
    None or empty). `device` resolves as the fitters' does (None: the card,
    which must exist): a CUDA device traces the CPU and CUDA activities and
    synchronizes the card before the profiler stops, so every kernel the
    block launched is in the trace; the CPU traces the CPU alone."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    from mbb_emcee_tpu_torch.fitter import resolve_device

    dev = resolve_device(device)
    _SPANS.clear()
    _OPEN.clear()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(
        str(log_dir), f"{socket.gethostname()}_{os.getpid()}."
                      f"{time.time_ns()}.pt.trace.json"))


@dataclasses.dataclass
class Span:
    """One recorded span: host times from time.perf_counter_ns(), the
    indices (into recorded()) of its parent (None for a root) and of its
    root, one per top-level program call."""
    name: str
    attrs: dict
    parent: int | None
    root: int
    start_ns: int = 0
    end_ns: int | None = None
    counters: dict = dataclasses.field(default_factory=dict)


_SPANS: list[Span] = []     # every span recorded, in the order opened
_OPEN: list = []            # the open spans' recordings, innermost last


class _Recording:
    __slots__ = ("name", "attrs", "index", "span", "_annotation")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.index = len(_SPANS)
        self.span = Span(self.name, self.attrs,
                         None if outer is None else outer.index,
                         self.index if outer is None else outer.span.root)
        _SPANS.append(self.span)
        _OPEN.append(self)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        self._annotation.__exit__(*exc)
        if _OPEN and _OPEN[-1] is self:     # trace() may have cleared it
            _OPEN.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span of host time named `name` (with attributes `attrs`) around
    the block, kept while torch's profiler records; no device is
    synchronised."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name, attrs)


def count(name: str, n: int):
    """Add n to the counter `name` of the innermost open span."""
    if not _OPEN:
        return
    counters = _OPEN[-1].span.counters
    counters[name] = counters.get(name, 0) + int(n)


def note(**attrs):
    """Add `attrs` to the attributes of the innermost open span."""
    if _OPEN:
        _OPEN[-1].span.attrs.update(attrs)


def recorded() -> list[Span]:
    """The spans recorded so far, in the order they opened (trace()
    clears them when it opens)."""
    return list(_SPANS)


class StepTimer:
    """Walker-steps/sec meter.

    >>> t = StepTimer(nwalkers=250)
    >>> with t.phase("production", nsteps=1000):
    ...     run()               # doctest: +SKIP
    >>> t.report()              # doctest: +SKIP
    """

    def __init__(self, nwalkers: int):
        self.nwalkers = int(nwalkers)
        self.phases: list[tuple[str, int, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, nsteps: int):
        t0 = time.perf_counter()
        yield
        self.phases.append((name, int(nsteps), time.perf_counter() - t0))

    def rate(self, name: str | None = None):
        """walker-steps/sec for one phase (or all phases combined)."""
        rows = [p for p in self.phases if name is None or p[0] == name]
        steps = sum(n for _, n, _ in rows)
        secs = sum(s for _, _, s in rows)
        return self.nwalkers * steps / secs if secs > 0 else float("nan")

    def report(self):
        lines = []
        for name, nsteps, secs in self.phases:
            rate = self.nwalkers * nsteps / secs if secs > 0 else 0.0
            lines.append(f"  {name}: {nsteps} steps in {secs:.2f}s "
                         f"({rate:,.0f} walker-steps/s)")
        return "\n".join(lines)
