"""Failure-detecting supervisor (scripts/supervise_train.py).

The hang mode this guards against: a device call that never returns leaves
the trainer blocked forever with no error.  These tests exercise the
detection/restart logic with fake trainers — no device needed.
"""

import subprocess
import sys
import time
from pathlib import Path

import importlib.util

SUP = Path(__file__).parents[1] / "scripts" / "supervise_train.py"
spec = importlib.util.spec_from_file_location("supervise_train", SUP)
sup = importlib.util.module_from_spec(spec)
spec.loader.exec_module(sup)


def test_newest_checkpoint(tmp_path):
    assert sup.newest_checkpoint(tmp_path) is None
    for step in (500, 10000, 2500):
        (tmp_path / f"ckpt_{step}.npz").write_bytes(b"")
    (tmp_path / "ckpt_bogus.npz").write_bytes(b"")
    assert sup.newest_checkpoint(tmp_path).name == "ckpt_10000.npz"


def test_run_once_clean_exit(tmp_path):
    hb = tmp_path / "metrics.jsonl"
    status, rc = sup.run_once(
        [sys.executable, "-c", "print('ok')"], hb, stall_timeout=60,
        poll_interval=0.2,
    )
    assert status == "ok" and rc == 0


def test_run_once_crash(tmp_path):
    hb = tmp_path / "metrics.jsonl"
    status, rc = sup.run_once(
        [sys.executable, "-c", "raise SystemExit(3)"], hb, stall_timeout=60,
        poll_interval=0.2,
    )
    assert status == "crash" and rc == 3


def test_run_once_detects_stall_and_kills_group(tmp_path):
    """A 'trainer' that heartbeats once then wedges (sleeps forever) gets its
    process group killed once the heartbeat goes stale."""
    hb = tmp_path / "metrics.jsonl"
    prog = (
        "import time, pathlib, sys\n"
        f"pathlib.Path({str(hb)!r}).write_text('beat')\n"
        "time.sleep(3600)\n"
    )
    t0 = time.time()
    status, rc = sup.run_once([sys.executable, "-c", prog], hb,
                              stall_timeout=2, poll_interval=0.2)
    assert status == "stall" and rc != 0
    assert time.time() - t0 < 30  # killed promptly, not after an hour


def test_pre_existing_heartbeat_does_not_trip(tmp_path):
    """An old metrics.jsonl from the previous run must not count as a stale
    heartbeat during the (heartbeat-less) startup phase."""
    hb = tmp_path / "metrics.jsonl"
    hb.write_text("old")
    old = time.time() - 10_000
    import os

    os.utime(hb, (old, old))
    status, rc = sup.run_once(
        # Wide margin: under a loaded box interpreter startup alone can take
        # seconds, and the stall clock runs from LAUNCH (the pre-existing
        # heartbeat must not count) — the timeout must dwarf startup+sleep.
        [sys.executable, "-c", "import time; time.sleep(1)"],
        hb,
        stall_timeout=15,
        poll_interval=0.2,
    )
    # process outlives several poll cycles without being killed, exits 0
    assert status == "ok" and rc == 0


def test_stall_before_first_heartbeat_is_detected(tmp_path):
    """A trainer that wedges BEFORE ever creating the heartbeat file (e.g. an
    RPC wedge during device init) must still trip the stall timeout — the
    missing-file window counts from launch time."""
    hb = tmp_path / "metrics.jsonl"  # never created by the fake trainer
    t0 = time.time()
    status, rc = sup.run_once(
        [sys.executable, "-c", "import time; time.sleep(3600)"],
        hb, stall_timeout=2, poll_interval=0.2,
    )
    assert status == "stall" and rc != 0
    assert time.time() - t0 < 30
