"""Failure-detecting training supervisor (SURVEY §5 failure detection).

Long training runs can die in ways the training process cannot observe from
inside: a device call hangs and the client blocks forever, the process
OOMs, or the host reboots.  The reference app has no answer to any of these
(a hung Metal command buffer kills the app).  Here
checkpoints are bit-exact-resumable (train/checkpoint.py), so the supervisor
turns every such failure into a bounded rollback:

  * spawns the training command in its own process group
  * watches the heartbeat file (metrics.jsonl) mtime
  * on stall (> --stall-timeout with no heartbeat) or crash, SIGKILLs the
    process GROUP (never pattern-kills), finds the newest ckpt_*.npz in the
    output dir, and relaunches with --resume
  * gives up after --max-restarts or when the trainer exits 0

    python scripts/supervise_train.py --stall-timeout 300 --out outputs/run \
        -- python train.py --dataset colmap --root scene --output outputs/run

(train.py appends every log line to <output>/metrics.jsonl, the heartbeat.)
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path


def newest_checkpoint(out_dir: Path):
    ckpts = []
    for p in out_dir.glob("ckpt_*.npz"):
        m = re.match(r"ckpt_(\d+)\.npz$", p.name)
        if m:
            ckpts.append((int(m.group(1)), p))
    return max(ckpts)[1] if ckpts else None


def run_once(cmd, heartbeat: Path, stall_timeout: float,
             poll_interval: float = 15.0):
    """Run cmd; return ('ok'|'crash'|'stall', returncode)."""
    proc = subprocess.Popen(cmd, start_new_session=True)
    started = time.time()  # a pre-existing heartbeat file must not count
    try:
        while True:
            try:
                rc = proc.wait(timeout=poll_interval)
                return ("ok" if rc == 0 else "crash"), rc
            except subprocess.TimeoutExpired:
                pass
            # A missing heartbeat file counts from launch time: a wedge
            # during import/device-init (before the trainer's startup touch)
            # must still trip the stall timeout, or the supervisor loops
            # forever on exactly the failure class it exists to handle.
            if heartbeat.exists():
                last = max(heartbeat.stat().st_mtime, started)
            else:
                last = started
            age = time.time() - last
            if age > stall_timeout:
                print(
                    f"[supervisor] heartbeat {heartbeat} stale "
                    f"{age:.0f}s > {stall_timeout:.0f}s — killing process "
                    f"group {proc.pid}",
                    flush=True,
                )
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                return "stall", -9
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stall-timeout", type=float, default=300.0,
                    help="seconds without a metrics heartbeat before the "
                         "trainer is declared hung")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="training output dir (parsed from the command's "
                         "--out if omitted)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- training command")
    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        sys.exit("no training command given (pass it after --)")

    out_dir = args.out
    if out_dir is None:
        for i, a in enumerate(cmd):
            if a == "--out" and i + 1 < len(cmd):
                out_dir = cmd[i + 1]
            elif a.startswith("--out="):
                out_dir = a.split("=", 1)[1]
    if out_dir is None:
        sys.exit("could not find --out in the command; pass --out explicitly")
    out_dir = Path(out_dir)
    heartbeat = out_dir / "metrics.jsonl"

    restarts = 0
    while True:
        run_cmd = list(cmd)
        ck = newest_checkpoint(out_dir)
        if ck is not None and "--resume" not in run_cmd:
            run_cmd += ["--resume", str(ck)]
        print(f"[supervisor] launch (restart {restarts}): "
              f"{' '.join(run_cmd)}", flush=True)
        status, rc = run_once(run_cmd, heartbeat, args.stall_timeout)
        if status == "ok":
            print("[supervisor] trainer exited cleanly", flush=True)
            return
        restarts += 1
        print(f"[supervisor] trainer {status} (rc={rc}); "
              f"restart {restarts}/{args.max_restarts}", flush=True)
        if restarts > args.max_restarts:
            sys.exit(f"giving up after {args.max_restarts} restarts")
        time.sleep(10)  # let the device recover


if __name__ == "__main__":
    main()
