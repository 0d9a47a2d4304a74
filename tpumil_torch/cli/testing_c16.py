"""Camelyon16 demo tester (counterpart of tpumil/cli/testing_c16.py, the
reference's testing_c16.py): 1-class tumour detection with the fixed
threshold 0.52827 and red attention maps.

    python -m tpumil_torch.cli.testing_c16 --device cuda \\
        --embedder_weights <embedder.pth> --aggregator_weights <c16_aggregator.pth> \\
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
        description="Camelyon16 testing: attention computing and color map production")
    parser.add_argument("--num_classes", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--feats_size", type=int, default=512)
    parser.add_argument("--thres_tumor", type=float, default=0.5282700061798096)
    parser.add_argument("--average", action="store_true")
    parser.add_argument("--aggregator_weights", type=str,
                        default="example_aggregator_weights/c16_aggregator.pth")
    parser.add_argument("--embedder_weights", type=str,
                        default=os.path.join("test-c16", "weights", "embedder.pth"))
    parser.add_argument("--bag_path", type=str, default=os.path.join("test-c16", "patches"))
    parser.add_argument("--output", type=str, default=os.path.join("test-c16", "output"))
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

    red = np.asarray([1.0, 0.0, 0.0])  # unit RGB
    bags_list = sorted(glob.glob(os.path.join(args.bag_path, "*")))
    os.makedirs(args.output, exist_ok=True)
    for bag_dir in bags_list:
        scores, attn, _, positions = infer.run_bag(bag_dir, "jpg", args.average)
        tumor = float(np.squeeze(scores)) >= args.thres_tumor
        # the reference's verdict strings: no colon, "malignant"/"benign"
        print(bag_dir + " is detected as "
              + ("malignant" if tumor else "benign"))
        cmap = render_single_class_map(
            attn[:, 0] if tumor else np.zeros(attn.shape[0]),
            positions, red if tumor else np.zeros(3))
        save_png(cmap, os.path.join(args.output,
                                    os.path.basename(bag_dir.rstrip(os.sep)) + ".png"))


if __name__ == "__main__":
    sys.exit(main())
