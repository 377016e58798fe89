"""CLI entry point mirroring the reference binary (src/main.rs:49-78).

    rray-tpu-torch -W <width> -H <height> -s <scene.yaml> -o <out.png> -a <aa>

Defaults 800x600, output.png, aa=1, device cuda; aa validated in 1..=5
(src/main.rs:23-44). With --checkpoint the frame renders in bands of
--band-rows rows and resumes from the checkpoint if it exists.
"""
from __future__ import annotations

import argparse
import logging
import sys


def parse_aa(value: str) -> int:
    try:
        aa = int(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"`{value}` isn't a valid number") from e
    if not (1 <= aa <= 5):
        raise argparse.ArgumentTypeError("anti-aliasing must be between 1 and 5")
    return aa


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rray-tpu-torch",
        description="A raytracer on PyTorch and CUDA (capability-parity "
                    "with rray)")
    p.add_argument("-W", "--width", type=int, default=800,
                   help="Width of the generated image (default 800)")
    p.add_argument("-H", "--height", type=int, default=600,
                   help="Height of the generated image (default 600)")
    p.add_argument("-s", "--scene", required=True,
                   help="Scene YAML file")
    p.add_argument("-o", "--output", default="output.png",
                   help="Output PNG file name (default output.png)")
    p.add_argument("-a", "--anti-aliasing", dest="aa", type=parse_aa,
                   default=1, help="Anti-aliasing level 1-5 (default 1)")
    p.add_argument("--seed", type=int, default=0,
                   help="Sampling seed (area lights); the reference uses "
                        "a nondeterministic thread RNG")
    p.add_argument("--device", default="cuda",
                   help="Torch device: cuda (the CUDA kernels; an error "
                        "without CUDA) or cpu (their plain PyTorch "
                        "versions). Default cuda")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Log each frame's time to render and copy to "
                        "the host")
    p.add_argument("--checkpoint", default=None,
                   help="Band-checkpoint file: render progressively and "
                        "resume from it if it exists (crash recovery)")
    p.add_argument("--band-rows", type=int, default=64,
                   help="Rows per checkpointed band (default 64)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s")
    if args.checkpoint:
        from .api import render_scene_progressive

        render_scene_progressive(args.scene, args.width, args.height,
                                 args.output, aa=args.aa, seed=args.seed,
                                 band_rows=args.band_rows,
                                 checkpoint_path=args.checkpoint,
                                 device=args.device)
        return 0
    from .api import render_scene_from_file

    render_scene_from_file(args.scene, args.width, args.height, args.output,
                           aa=args.aa, seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
