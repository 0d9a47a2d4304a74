"""TCGA lung demo tester (counterpart of tpumil/cli/testing_tcga.py, the
reference's testing_tcga.py): 2-class LUAD/LUSC with fixed thresholds,
green/blue maps, and the four-way verdict.

    python -m tpumil_torch.cli.testing_tcga --device cuda \\
        --embedder_weights <embedder.pth> --aggregator_weights <tcga_aggregator.pth> \\
        --bag_path <folder of bag folders> --output <output folder>
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from tpumil_torch.cli.attention_map import (DATA_PARALLEL_HELP, load_milnet,
                                            run_data_parallel)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="TCGA testing: attention computing and color map production")
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--feats_size", type=int, default=512)
    parser.add_argument("--thres_luad", type=float, default=0.45798203349113464)
    parser.add_argument("--thres_lusc", type=float, default=0.5827295184135437)
    parser.add_argument("--average", action="store_true")
    parser.add_argument("--aggregator_weights", type=str,
                        default="example_aggregator_weights/tcga_aggregator.pth")
    parser.add_argument("--embedder_weights", type=str,
                        default=os.path.join("test", "weights", "embedder.pth"))
    parser.add_argument("--bag_path", type=str, default=os.path.join("test", "patches"))
    parser.add_argument("--output", type=str, default=os.path.join("test", "output"))
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    parser.add_argument("--data_parallel", default=0, type=int, metavar="N",
                        help=DATA_PARALLEL_HELP)
    return parser.parse_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    return run_data_parallel(main, argv, args, "embedding",
                             lambda m: _run(args, m))


def _run(args, mesh) -> int:
    from tpumil_torch.infer.heatmap import BagInference
    from tpumil_torch.parallel.mesh import lead
    from tpumil_torch.utils.device import select_device

    emb, _, agg, model_name = load_milnet(
        args.embedder_weights, args.aggregator_weights, args.num_classes,
        select_device(args.device))
    infer = BagInference(emb, agg, batch_size=args.batch_size,
                         num_workers=args.num_workers, model=model_name,
                         mesh=mesh)
    lead(mesh, lambda: _maps(args, infer))
    return 0


def _maps(args, infer) -> None:
    from tpumil_torch.infer.heatmap import render_single_class_map, save_png

    # LUAD green, LUSC blue, unit RGB: the raw attention is rescaled first,
    # then scaled by the colour
    colors = [np.asarray([0.0, 1.0, 0.0]), np.asarray([0.0, 0.0, 1.0])]
    black = np.zeros(3)
    bags_list = sorted(glob.glob(os.path.join(args.bag_path, "*")))
    os.makedirs(args.output, exist_ok=True)
    for bag_dir in bags_list:
        scores, attn, _, positions = infer.run_bag(bag_dir, "jpg", args.average)
        scores = np.atleast_1d(np.squeeze(scores))
        luad, lusc = scores[0] >= args.thres_luad, scores[1] >= args.thres_lusc
        if luad and not lusc:
            verdict, cls = "LUAD", 0
        elif lusc and not luad:
            verdict, cls = "LUSC", 1
        elif not luad and not lusc:
            verdict, cls = "benign", None
        else:
            # the reference leaves the colour black in this branch
            verdict, cls = "both LUAD and LUSC", None
        print(bag_dir + " is detected as: " + verdict)
        cmap = render_single_class_map(
            attn[:, cls] if cls is not None else np.zeros(attn.shape[0]),
            positions, colors[cls] if cls is not None else black)
        save_png(cmap, os.path.join(args.output,
                                    os.path.basename(bag_dir.rstrip(os.sep)) + ".png"))


if __name__ == "__main__":
    sys.exit(main())
