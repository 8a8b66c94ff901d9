"""Hierarchical wall-clock section profiler + jax.profiler trace helper.

Counterpart of IntervalProfiler (Trainer/GaussianTrainer.swift:122-241):
nested `measure("name")` scopes with self/total/count accounting and a top-K
report.  On an accelerator, sections that should attribute device time must
pass `sync=True` so the scope blocks on the returned arrays (the analogue of the
reference forcing `eval` inside measured sections,
GaussianRenderer.swift:157-171).  For kernel-level analysis use `trace()`
which wraps `jax.profiler.trace` (view in XProf/Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


@dataclass
class _Section:
    total: float = 0.0
    child: float = 0.0
    count: int = 0

    @property
    def self_time(self) -> float:
        return self.total - self.child


class IntervalProfiler:
    """Nested-scope timer with parent-child attribution."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sections: Dict[str, _Section] = {}
        self._stack: List[List] = []  # frames: [name, start, child_accum]

    @contextlib.contextmanager
    def measure(self, name: str, sync_on=None):
        """Time a scope.  `sync_on`: arrays to block_until_ready before
        closing the scope so device time lands in the right section."""
        if not self.enabled:
            yield
            return
        self._stack.append([name, time.perf_counter(), 0.0])
        try:
            yield
        finally:
            if sync_on is not None:
                jax.block_until_ready(sync_on)
            frame = self._stack.pop()
            elapsed = time.perf_counter() - frame[1]
            sec = self.sections.setdefault(name, _Section())
            sec.total += elapsed
            sec.child += frame[2]
            sec.count += 1
            if self._stack:
                self._stack[-1][2] += elapsed

    def report(self, top_k: int = 12) -> str:
        """Top-K sections by self time (GaussianTrainer.swift:180-240)."""
        rows = sorted(
            self.sections.items(), key=lambda kv: kv[1].self_time, reverse=True
        )[:top_k]
        lines = [f"{'section':40s} {'self(ms)':>10s} {'total(ms)':>10s} {'count':>7s}"]
        for name, sec in rows:
            lines.append(
                f"{name:40s} {sec.self_time * 1e3:10.2f} "
                f"{sec.total * 1e3:10.2f} {sec.count:7d}"
            )
        return "\n".join(lines)

    def reset(self):
        self.sections.clear()


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """Capture a device trace viewable in XProf/Perfetto — the analogue
    of the reference's Metal GPU capture (TrainView.swift:109-117)."""
    with jax.profiler.trace(log_dir):
        yield
    print(f"trace written to {log_dir}")
