"""Optional ``torch.profiler`` hooks: attribute device time to solves.

The counterpart of `repro.obs.jaxprof`.  The span tree measures host wall
time; to see *device* time per solve, set ``REPRO_OBS_TORCH=1`` and the
instrumented solve sites (``fiedler:lanczos``, ``fiedler:inverse``, ...)
wrap themselves in :func:`annotate`: a ``torch.profiler.record_function``
range, which a ``torch.profiler`` capture shows with the CUDA kernels it
launched beneath it, plus an NVTX range of the same name on the card.
Default is off: with the gate off :func:`annotate` is a free null context.

:func:`maybe_start_trace` / :func:`maybe_stop_trace` bracket a whole
capture; the stop writes a Chrome trace (open it at
https://ui.perfetto.dev) into ``REPRO_OBS_TORCH_DIR`` (default
``runs/torchprof``).  Both are no-ops when the gate is off.  A capture
that was asked for and fails to start or to write raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


def _torch_enabled() -> bool:
    return os.environ.get("REPRO_OBS_TORCH", "").strip().lower() in (
        "1", "on", "true", "yes")


@contextlib.contextmanager
def _range(name: str):
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """A ``record_function`` + NVTX range named ``name`` when
    ``REPRO_OBS_TORCH=1``, else a free null context."""
    if not _torch_enabled():
        return contextlib.nullcontext()
    return _range(name)


@dataclasses.dataclass
class Capture:
    """A running capture: the ``torch.profiler.profile`` (read its events
    after :func:`maybe_stop_trace`) and the directory its trace goes to."""

    profile: torch.profiler.profile
    log_dir: str


def maybe_start_trace(log_dir: str | None = None) -> Capture | None:
    """Start a ``torch.profiler`` capture (CPU, and CUDA where there is a
    card) if ``REPRO_OBS_TORCH=1``.  Returns the :class:`Capture` — pass
    it to :func:`maybe_stop_trace` — or None when the gate is off."""
    if not _torch_enabled():
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return Capture(prof, log_dir or os.environ.get("REPRO_OBS_TORCH_DIR",
                                                   "runs/torchprof"))


def maybe_stop_trace(cap: Capture | None) -> str | None:
    """Stop the capture :func:`maybe_start_trace` returned and write its
    Chrome trace; returns the file's path (None for no capture)."""
    if cap is None:
        return None
    cap.profile.stop()
    os.makedirs(cap.log_dir, exist_ok=True)
    path = os.path.join(cap.log_dir,
                        f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                        f"{os.getpid()}.json")
    cap.profile.export_chrome_trace(path)
    return path
