"""Export a training checkpoint's model to a reference-compatible PLY.

An interrupted campaign leaves only ckpt_*.npz (the trainer writes
iteration_*.ply solely when run() completes), but every downstream consumer —
eval.py, render_cli.py, the reference's own viewers (PlyWriter layout,
reference Model/PlyWriter.swift) — speaks PLY.  This bridges the gap:

    python scripts/ckpt_to_ply.py outputs/flagship_vendor            # newest
    python scripts/ckpt_to_ply.py outputs/run/ckpt_6000.npz -o m.ply

Runs on the CPU, so it never competes with a live training run for the
card.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def newest_checkpoint(d: Path) -> Path:
    cks = sorted(d.glob("ckpt_*.npz"), key=lambda p: int(p.stem.split("_")[1]))
    if not cks:
        sys.exit(f"no ckpt_*.npz under {d}")
    return cks[-1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="checkpoint .npz or a directory of them")
    ap.add_argument("-o", "--out", default=None,
                    help="output .ply (default: iteration_<step>.ply next to "
                    "the checkpoint)")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from gaussiansplattingmlx_tpu.data import ply
    from gaussiansplattingmlx_tpu.train import checkpoint

    src = Path(args.path)
    if src.is_dir():
        src = newest_checkpoint(src)
    state, _, _ = checkpoint.load(src)
    n = int(state.num_active)
    p = jax.device_get(state.params)
    out = Path(args.out) if args.out else (
        src.parent / f"iteration_{int(state.step)}.ply"
    )
    ply.write_gaussian_ply(
        out, p.xyz[:n], p.features_dc[:n], p.features_rest[:n],
        p.opacity[:n], p.scales[:n], p.rotation[:n],
    )
    print(f"{src} (step {int(state.step)}, {n} gaussians) -> {out}")


if __name__ == "__main__":
    main()
