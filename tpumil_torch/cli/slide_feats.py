"""One-pass slide -> features: tiling and embedding fused, no JPEG round
trip (counterpart of tpumil/cli/slide_feats.py).

    python -m tpumil_torch.cli.slide_feats --device cuda --dataset <name> \\
        --slide_format tif --weights <run folder | model.pth>

Reads ``<wsi_root>/<dataset>/<class>/*.<slide_format>`` and writes
``<out_root>/<dataset>/<class>/<slide>.csv`` (the features), its
``<slide>.pos.csv`` sidecar (each kept tile's col,row) and the master
``<out_root>/<dataset>/<dataset>.csv`` that ``tpumil_torch.cli.train_wsi``
trains on.

``--data_parallel N`` splits each tile batch's rows over N devices, one
process each (started here, or by ``torchrun``); rank 0 reads the slides
and writes, the other ranks follow its batches.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Stream slides straight into per-bag feature CSVs "
                    "(PyTorch port)")
    parser.add_argument("--dataset", required=True, type=str)
    parser.add_argument("--wsi_root", default="WSI", type=str)
    parser.add_argument("--out_root", default="datasets", type=str)
    parser.add_argument("--slide_format", default="svs", type=str)
    parser.add_argument("--num_classes", default=1, type=int)
    parser.add_argument("--backbone", default="resnet18", type=str)
    parser.add_argument("--norm_layer", default="instance", type=str)
    parser.add_argument("--weights", default=None, type=str,
                        help="SimCLR run folder or explicit .pth path")
    parser.add_argument("--tile_size", default=224, type=int)
    parser.add_argument("--base_mag", default=20, type=float)
    parser.add_argument("--objective", default=20, type=float)
    parser.add_argument("--background_t", default=15, type=float)
    parser.add_argument("--magnifications", type=int, nargs="+", default=(0,))
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--workers", default=4, type=int)
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
    parser.add_argument("--precision", default="f32",
                        choices=["bf16", "f32", "f32h", "f32x"],
                        help="bf16: bf16 activations; f32 (default), f32h, "
                             "f32x: true f32 (no TF32), the one f32 tier of "
                             "the port")
    parser.add_argument("--shard", type=str, default=None,
                        help="'i/n': process only every n-th slide starting "
                             "at i (multi-host scale-out; assemble the "
                             "dataset CSVs after all shards finish)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    return parser


def main(argv=None):
    from tpumil_torch.cli.attention_map import run_data_parallel

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return run_data_parallel(main, argv, args, "extraction",
                             lambda m: _run(args, m))


def _run(args, mesh) -> int:
    import glob
    import os

    from tpumil_torch.data.tiler import TilerConfig
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.stream_embed import embed_dataset_streaming
    from tpumil_torch.models import embedder
    from tpumil_torch.parallel.mesh import is_main, lead
    from tpumil_torch.utils.device import select_device
    from tpumil_torch.utils.sharding import parse_shard

    device = select_device(args.device)
    cfg = embedder.EmbedderConfig(backbone=args.backbone, norm=args.norm_layer,
                                  num_classes=args.num_classes,
                                  precision=args.precision,
                                  space_to_depth=args.space_to_depth)
    if args.weights and os.path.exists(args.weights):
        path = args.weights
    elif args.weights:
        path = os.path.join("simclr", "runs", args.weights, "checkpoints",
                            "model.pth")
    else:
        cands = sorted(glob.glob("simclr/runs/*/checkpoints/*.pth"))
        path = cands[-1] if cands else None
    if path is None:
        if is_main():
            print("no SimCLR weights found; using random init")
        model = embedder.init_params(0, cfg, device)
    else:
        model = embedder.load_simclr_checkpoint(path, cfg, device)

    extractor = FeatureExtractor(model, args.batch_size, args.tile_size,
                                 mesh=mesh)
    tiler_cfg = TilerConfig(tile_size=args.tile_size, base_mag=args.base_mag,
                            objective=args.objective,
                            background_threshold=args.background_t,
                            workers=args.workers)

    def work():
        master = embed_dataset_streaming(
            args.wsi_root, args.dataset, extractor, args.out_root, tiler_cfg,
            args.slide_format, tuple(args.magnifications),
            batch_size=args.batch_size, shard=parse_shard(args.shard))
        if master:
            print(f"master CSV: {master}")

    lead(mesh, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
