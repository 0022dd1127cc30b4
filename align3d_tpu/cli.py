"""Command-line interface.

Counterpart of the reference's example binaries (``examples/src/bin/``):

* ``odometry`` — frame-to-frame odometry with trajectory metrics
  (odometry.rs: format/dataset/max_frames args + progress bar);
* ``viewer`` — render dataset frames + trajectory to PNG (the headless
  stand-in for the Vulkan dataset viewer).
"""

from __future__ import annotations

import argparse
import sys


def _progress_printer(total_width: int = 40):
    def show(i, n):
        done = int(total_width * i / n)
        bar = "#" * done + "-" * (total_width - done)
        print(f"\rProcessing frames [{bar}] {i}/{n}", end="", file=sys.stderr)
        if i == n:
            print(file=sys.stderr)

    return show


def cmd_odometry(args) -> int:
    from align3d_tpu.config import enable_compile_cache
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.io.datasets import SubsetDataset, load_dataset
    from align3d_tpu.odometry import run_odometry
    from align3d_tpu.ops.bilateral import BilateralFilter
    from align3d_tpu.range_image import RangeImageBuilder

    from align3d_tpu.io.datasets.core import maybe_prefetch

    enable_compile_cache()
    # Native decode-ahead pipeline (C++ worker pool) when built.
    dataset = maybe_prefetch(load_dataset(args.format, args.dataset))
    if args.max_frames is not None:
        dataset = SubsetDataset(dataset, range(args.max_frames))

    builder = RangeImageBuilder(
        bilateral_filter=None if args.no_bilateral else BilateralFilter()
    )
    params = MsIcpParams.default().customize(
        lambda i, p: p.replace(engine=args.engine)
    )
    result = run_odometry(
        dataset,
        range_builder=builder,
        icp_params=params,
        progress=_progress_printer() if not args.quiet else None,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
    )
    if args.loop_closure:
        from align3d_tpu.odometry import refine_with_loop_closures

        before = f"{result.metrics}" if result.metrics is not None else "n/a"
        result = refine_with_loop_closures(
            dataset, result, range_builder=builder, icp_params=params
        )
        print(f"Mean trajectory error before loop closure: {before}")
    if result.metrics is not None:
        print(f"Mean trajectory error: {result.metrics}")
    print(f"Seconds per frame: {result.seconds_per_frame:.4f}")

    if args.save_trajectory:
        with open(args.save_trajectory, "w") as f:
            f.write(result.trajectory.to_tum())
        print(f"Trajectory written to {args.save_trajectory} (TUM format)")

    if args.show is not None:
        # Reference --show hands off to the dataset viewer
        # (examples/src/bin/odometry.rs:15-28 + rgbd_dataset_viewer.rs); the
        # headless analog renders the clouds posed by the ESTIMATED
        # trajectory: a GIF fly-through for .gif outputs, else a PNG.
        from align3d_tpu.viz.dataset_viewer import (
            render_dataset_flythrough,
            render_dataset_preview,
        )

        render = (
            render_dataset_flythrough
            if args.show.lower().endswith(".gif")
            else render_dataset_preview
        )
        out = render(
            args.format,
            args.dataset,
            args.show,
            max_frames=args.max_frames,
            trajectory=result.trajectory,
        )
        print(f"Wrote {out}")
    return 0


def cmd_viewer(args) -> int:
    from align3d_tpu.viz.dataset_viewer import (
        render_dataset_flythrough,
        render_dataset_preview,
    )

    if args.interactive:
        from align3d_tpu.io.datasets import load_dataset
        from align3d_tpu.viz.viewers import RgbdDatasetViewer

        dataset = load_dataset(args.format, args.dataset)
        # Unless explicitly capped, keep the interactive scene at show()'s
        # own default (8 frames) — a full TUM sequence would otherwise load
        # thousands of frames into the software renderer before serving.
        max_frames = args.max_frames if args.max_frames is not None else 8
        RgbdDatasetViewer(dataset).show(max_frames=max_frames, port=args.port)
        return 0
    if args.animate or args.output.lower().endswith(".gif"):
        out = render_dataset_flythrough(
            args.format,
            args.dataset,
            args.output if args.output.lower().endswith(".gif")
            else args.output + ".gif",
            max_frames=args.max_frames,
        )
    else:
        out = render_dataset_preview(
            args.format, args.dataset, args.output, max_frames=args.max_frames
        )
    print(f"Wrote {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="align3d_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    p_odo = sub.add_parser("odometry", help="frame-to-frame odometry over a dataset")
    p_odo.add_argument("format", help="dataset format: ilrgbd, tum, or slamtb")
    p_odo.add_argument("dataset", help="path to the dataset directory")
    p_odo.add_argument("max_frames", nargs="?", type=int, default=None)
    p_odo.add_argument("--no-bilateral", action="store_true")
    p_odo.add_argument(
        "--engine",
        choices=("xla", "fused"),
        default="xla",
        help="ICP engine at every pyramid level: packed XLA gathers, or the "
        "fused kernel (NVIDIA GPU only); both associate exactly",
    )
    p_odo.add_argument(
        "--loop-closure",
        action="store_true",
        help="after odometry, detect loop closures and refine the "
        "trajectory with pose-graph Gauss-Newton",
    )
    p_odo.add_argument("--quiet", "-q", action="store_true")
    p_odo.add_argument("--save-trajectory", metavar="PATH")
    p_odo.add_argument(
        "--checkpoint",
        metavar="PATH",
        help="snapshot the in-progress trajectory here and RESUME from it "
        "if the file exists (aborted runs continue where they stopped)",
    )
    def _positive_int(value: str) -> int:
        v = int(value)
        if v < 1:
            raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
        return v

    p_odo.add_argument("--checkpoint-every", type=_positive_int, default=10)
    p_odo.add_argument(
        "--show",
        metavar="PATH",
        default=None,
        help="after odometry, render the reconstruction posed by the "
        "estimated trajectory (reference odometry --show): animated GIF "
        "fly-through if PATH ends in .gif, else a single PNG",
    )
    p_odo.set_defaults(fn=cmd_odometry)

    p_view = sub.add_parser("viewer", help="render dataset + trajectory preview PNG")
    p_view.add_argument("format")
    p_view.add_argument("dataset")
    p_view.add_argument("--output", "-o", default="dataset_preview.png")
    p_view.add_argument("--max-frames", type=int, default=None)
    p_view.add_argument(
        "--animate",
        action="store_true",
        help="render an orbiting GIF fly-through instead of a single PNG",
    )
    p_view.add_argument(
        "--interactive",
        action="store_true",
        help="serve an interactive viewer (WASD fly, mouse orbit, 1..9 "
        "visibility toggles, Q quit) at http://127.0.0.1:PORT/",
    )
    p_view.add_argument("--port", type=int, default=8700)
    p_view.set_defaults(fn=cmd_viewer)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
