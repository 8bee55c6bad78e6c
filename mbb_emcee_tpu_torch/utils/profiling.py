"""Tracing hooks and step-rate timing.

Torch twin of mbb_emcee_tpu/utils/profiling.py:

  * `trace(dir, device=None)` -- context manager around torch.profiler; on
    a CUDA device it records the host's operators and the card's kernels
    (the fused sampling kernels among them) and writes one Chrome trace
    (`*.pt.trace.json`) into `dir`, which opens in Perfetto
    (ui.perfetto.dev) or chrome://tracing. Wired to both MBB CLIs as
    --profile-dir. The JAX package writes jax.profiler's TensorBoard
    format instead.
  * `StepTimer` -- wall-clock walker-steps/sec meter with the JAX
    package's phase / rate / report output.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time


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
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mbb_emcee_tpu_torch.fitter import resolve_device

    dev = resolve_device(device)
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
