"""Per-phase timing + peak-memory reports.

Parity: libgramtools src/common/timer_report.cpp:10-48 (TimerReport)
plus the sdsl memory monitor the reference wraps around FM-index
construction (src/prg/make_data_structures.cpp:12-29): each phase
records its peak RSS alongside wall time (Linux VmHWM, reset per phase
via /proc/self/clear_refs when writable; falls back to the monotone
high-water mark otherwise). Extended with a jax.profiler trace hook for
device kernel inspection.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import List, Optional, Tuple

log = logging.getLogger("gramtools_tpu")


def _read_vm_hwm_bytes() -> Optional[int]:
    """Peak resident set size of this process, bytes (Linux)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _reset_vm_hwm() -> bool:
    """Reset the kernel's peak-RSS counter so the next VmHWM read is a
    per-phase peak (writing '5' to clear_refs; needs permission)."""
    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5\n")
        return True
    except OSError:
        return False


class TimerReport:
    def __init__(self):
        # (name, seconds, peak_rss_bytes or None)
        self.entries: List[Tuple[str, float, Optional[int]]] = []
        self._start = None
        self._name = None

    def start(self, name: str):
        self._name = name
        _reset_vm_hwm()
        self._start = time.perf_counter()

    def stop(self):
        if self._name is None:
            return
        self.entries.append((self._name, time.perf_counter() - self._start,
                             _read_vm_hwm_bytes()))
        self._name = None

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def report(self):
        log.info("Timer report:")
        total = 0.0
        for name, elapsed, peak in self.entries:
            mem = f"  peak {peak / 1e6:8.1f}MB" if peak else ""
            log.info("  %-24s %8.2fs%s", name, elapsed, mem)
            total += elapsed
        log.info("  %-24s %8.2fs", "TOTAL", total)

    def as_dict(self):
        """Per-phase {seconds, peak_mem_mb} for command report JSONs."""
        return {name: {
            "seconds": round(elapsed, 3),
            "peak_mem_mb": round(peak / 1e6, 1) if peak else None,
        } for name, elapsed, peak in self.entries}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a region; view with tensorboard/xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
