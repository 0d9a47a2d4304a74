"""Compute per-bag features from a (SimCLR-pretrained) embedder: the
reference's compute_feats.py flags and outputs (counterpart of
tpumil/cli/compute_feats.py).

    python -m tpumil_torch.cli.compute_feats --device cuda --dataset <name> \\
        --weights <run folder | model.pth | ImageNet>

Reads patches from ``<wsi_root>/<dataset>/{single,pyramid}/<class>/<bag>/``,
writes ``<out_root>/<dataset>/<class>/<bag>.csv``, the per-class bag lists
and the master ``<out_root>/<dataset>/<dataset>.csv`` that
``tpumil_torch.cli.train_wsi`` trains on, and the embedder it used under
``embedder/<dataset>/``.

``--data_parallel N`` splits each patch batch's rows over N devices, one
process each (started here, or by ``torchrun``); rank 0 decodes, prints
and writes, the other ranks follow its batches.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute features from a SimCLR embedder (PyTorch port)")
    parser.add_argument("--num_classes", default=2, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--num_workers", default=8, type=int,
                        help="Host JPEG-decode threads")
    parser.add_argument("--backbone", default="resnet18", type=str,
                        help="resnet18|resnet34|resnet50|resnet101")
    parser.add_argument("--norm_layer", default="instance", type=str,
                        help="instance|batch")
    parser.add_argument("--magnification", default="single", type=str,
                        help="single|low|high|tree")
    parser.add_argument("--weights", default=None, type=str,
                        help="SimCLR run folder under simclr/runs/, an "
                             "explicit .pth path, or 'ImageNet'")
    parser.add_argument("--weights_high", default=None, type=str)
    parser.add_argument("--weights_low", default=None, type=str)
    parser.add_argument("--tree_fusion", default="cat", type=str, help="cat|fusion")
    parser.add_argument("--dataset", default="TCGA-lung-single", type=str)
    parser.add_argument("--wsi_root", default="WSI", type=str)
    parser.add_argument("--out_root", default="datasets", type=str)
    parser.add_argument("--patch_size", default=224, type=int)
    parser.add_argument("--precision", default="f32",
                        choices=["bf16", "f32", "f32h", "f32x"],
                        help="bf16: bf16 activations; f32 (default), f32h, "
                             "f32x: true f32 (no TF32), the one f32 tier of "
                             "the port")
    parser.add_argument("--gpu_index", type=int, nargs="+", default=(0,),
                        help="Accepted for reference CLI compatibility "
                             "(compute_feats.py --gpu_index); device "
                             "selection here is --device")
    parser.add_argument("--shard", type=str, default=None,
                        help="'i/n': process only every n-th bag starting "
                             "at i (multi-host scale-out of this stage; "
                             "run --assemble_only once after all shards "
                             "finish to build the dataset CSVs)")
    parser.add_argument("--assemble_only", action="store_true",
                        help="Skip extraction; just assemble the per-class "
                             "and master dataset CSVs from existing bag CSVs")
    parser.add_argument("--space_to_depth", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="2x2 space-to-depth stem rewrite: the same "
                             "features in another summation order; "
                             "--no-space_to_depth restores the plain 7x7/s2 "
                             "stem. Moot for instance norm at 224^2, whose "
                             "stem is the fused kernel")
    parser.add_argument("--data_parallel", default=0, type=int, metavar="N",
                        help="Shard each patch batch over N devices, one "
                             "process each; batch_size must divide by N "
                             "[0 = off]")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    return parser


def config_from_args(args):
    """The EmbedderConfig this CLI runs."""
    from tpumil_torch.models.embedder import EmbedderConfig

    return EmbedderConfig(backbone=args.backbone, norm=args.norm_layer,
                          num_classes=args.num_classes,
                          precision=args.precision,
                          space_to_depth=args.space_to_depth)


def main(argv=None):
    from tpumil_torch.cli.attention_map import run_data_parallel

    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    return run_data_parallel(main, argv, args, "extraction",
                             lambda m: _run(parser, args, m))


def _run(parser, args, mesh) -> int:
    from tpumil_torch.data.feature_store import build_dataset_csvs
    from tpumil_torch.data.patches import list_bag_dirs
    from tpumil_torch.infer.features import (FeatureExtractor, compute_feats,
                                             compute_tree_feats)
    from tpumil_torch.io import torch_ckpt
    from tpumil_torch.models import embedder
    from tpumil_torch.parallel.mesh import is_main, lead
    from tpumil_torch.utils.device import select_device
    from tpumil_torch.utils.sharding import parse_shard

    device = select_device(args.device)
    cfg = config_from_args(args)
    # rank 0 alone prints and writes
    say = print if is_main() else (lambda *a: None)

    def resolve_weights(spec):
        if spec is None:
            cands = sorted(glob.glob("simclr/runs/*/checkpoints/*.pth"))
            if not cands:
                parser.error("no SimCLR checkpoints under simclr/runs/")
            return cands[-1]
        if os.path.exists(spec):
            return spec
        return os.path.join("simclr", "runs", spec, "checkpoints", "model.pth")

    def load(spec, export_name):
        if spec == "ImageNet" or args.weights == "ImageNet":
            if args.norm_layer != "batch":
                raise ValueError("Please use batch normalization for ImageNet feature")
            # no download here: ImageNet weights come as a local .pth
            say("ImageNet weights requested; supply a local .pth via --weights "
                "<path> for real features. Using random init.")
            return embedder.init_params(0, cfg, device)
        model = embedder.load_simclr_checkpoint(resolve_weights(spec), cfg,
                                                device)
        if is_main():
            os.makedirs(os.path.join("embedder", args.dataset), exist_ok=True)
            torch_ckpt.save_state_dict(
                embedder.export_embedder_state_dict(model),
                os.path.join("embedder", args.dataset, export_name))
        say("Use pretrained features.")
        return model

    def extractor(model):
        return FeatureExtractor(model, args.batch_size, args.patch_size,
                                args.num_workers, mesh=mesh)

    feats_path = os.path.join(args.out_root, args.dataset)
    if is_main():
        os.makedirs(feats_path, exist_ok=True)
    if args.assemble_only:
        if is_main():
            master = build_dataset_csvs(feats_path, args.dataset)
            print(f"master CSV: {master}")
        return 0
    bag_dirs = list_bag_dirs(args.wsi_root, args.dataset, args.magnification)
    shard = parse_shard(args.shard)
    if shard is not None:
        i, n = shard
        bag_dirs = bag_dirs[i::n]
        say(f"shard {i}/{n}: {len(bag_dirs)} bags")

    if args.magnification == "tree":
        if args.weights_high is None or args.weights_low is None:
            parser.error("--magnification tree requires --weights_high and --weights_low")
        extractors = (extractor(load(args.weights_high, "embedder-high.pth")),
                      extractor(load(args.weights_low, "embedder-low.pth")))
    else:
        extractors = (extractor(load(args.weights, "embedder.pth")),)

    def work():
        log = lambda s: (sys.stdout.write(s), sys.stdout.flush())
        if args.magnification == "tree":
            ex_h, ex_l = extractors
            compute_tree_feats(bag_dirs, ex_l, ex_h, feats_path,
                               args.tree_fusion, log)
        else:
            compute_feats(bag_dirs, extractors[0], feats_path,
                          args.magnification, log)
        stats = extractors[0].stats
        if shard is None:
            build_dataset_csvs(feats_path, args.dataset)
        else:
            print("shard done; run --assemble_only after all shards finish "
                  "to build the dataset CSVs")
        print(f"Throughput: {stats.patches_per_sec:.1f} patches/sec "
              f"({stats.patches} patches)")

    lead(mesh, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
