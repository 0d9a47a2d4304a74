"""Attention heatmap CLI (counterpart of tpumil/cli/attention_map.py, the
reference's attention_map.py), and ``load_milnet``, the model assembly that
the three inference scripts share.

    python -m tpumil_torch.cli.attention_map --device cuda \\
        --embedder_weights <embedder.pth> --aggregator_weights <aggregator.pth> \\
        --bag_path <folder of bag folders> --map_path <output folder>

Each bag folder holds ``<a>_<b>.jpg`` patches; each bag gets
``<map_path>/<bag>.png`` and, with ``--export_scores 1``,
``<score_path>/<bag>.csv`` of per-patch attention scores.

``--data_parallel N`` (here and in testing_tcga, testing_c16, serve):
each patch batch's rows are split over N devices, one process each
(``run_data_parallel``); rank 0 reads, aggregates, prints and writes.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch


def load_milnet(embedder_weights: str, aggregator_weights: str,
                num_classes: int, device: torch.device, norm: str = "instance",
                backbone: str = "resnet18", precision: str = "f32",
                space_to_depth: bool = False):
    """Embedder by the positional surgery, aggregator from a ``.pth`` of any
    registry schema, instance head overwritten from the aggregator's
    ``i_classifier.fc.0.*`` (DSMIL) or ``i_classifier.fc.*`` (the others),
    as the reference's attention_map.py does.

    ``precision`` defaults to f32: the shipped reference thresholds were
    derived from f32 torch inference. ``embedder_weights="ImageNet"`` gives
    a seeded random-init embedder (no weights are downloaded).

    Returns (embedder, emb_cfg, aggregator, model_name)."""
    from tpumil_torch.io import torch_ckpt
    from tpumil_torch.models import embedder
    from tpumil_torch.models.embedder import EmbedderConfig
    from tpumil_torch.models.registry import require_instance_stream

    agg, agg_cfg, model_name = torch_ckpt.load_mil_pth(aggregator_weights,
                                                       device)
    # the embedder's head is the aggregator's instance classifier
    require_instance_stream(model_name, "an embedder with a slide head")
    if agg_cfg.num_classes != num_classes:
        raise ValueError(
            f"aggregator has {agg_cfg.num_classes} classes, expected "
            f"{num_classes} (check --num_classes / the checkpoint)")
    emb_cfg = EmbedderConfig(backbone=backbone, norm=norm,
                             num_classes=agg_cfg.num_classes,
                             precision=precision, space_to_depth=space_to_depth)
    if embedder_weights == "ImageNet":
        from tpumil_torch.parallel.mesh import is_main

        if is_main():
            print("ImageNet embedder requested; supply a local .pth for real "
                  "features. Using a seeded random init.")
        emb = embedder.init_params(0, emb_cfg, device)
    else:
        emb = embedder.load_simclr_checkpoint(embedder_weights, emb_cfg, device)
    fc = agg.i_classifier.fc
    if isinstance(fc, torch.nn.Sequential):
        fc = fc[0]
    emb.set_head(fc.weight.detach(), fc.bias.detach())
    return emb, emb_cfg, agg, model_name


DATA_PARALLEL_HELP = (
    "Shard each patch batch over N devices, one process each (started "
    "here, or by torchrun); batch_size must divide by N; the per-bag "
    "aggregator runs on rank 0 [0 = off]")


def run_data_parallel(main, argv, args, what: str, body) -> int:
    """``--data_parallel N`` around a CLI's ``body(mesh)``: N's refusals
    (negative, not dividing ``args.batch_size``) first; N > 1 without a
    process group starts N workers, each running ``main(argv)``; on each
    rank ``body`` runs with the mesh (None for N = 0), and rank 0's work
    inside it goes through ``parallel/mesh.lead``."""
    from tpumil_torch.parallel import mesh

    mesh.check_data_parallel(args.data_parallel, args.batch_size)
    if mesh.start_workers(main, argv, args.data_parallel, args.device):
        return 0
    with mesh.data_parallel(args.data_parallel, what, args.device) as m:
        return body(m)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Attention computing and color map production")
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--feats_size", type=int, default=512)
    parser.add_argument("--thres", nargs="+", type=float, default=[0.7371, 0.2752])
    parser.add_argument("--class_name", nargs="+", type=str, default=None)
    parser.add_argument("--embedder_weights", type=str, default="test/weights/embedder.pth")
    parser.add_argument("--aggregator_weights", type=str, default="test/weights/aggregator.pth")
    parser.add_argument("--bag_path", type=str, default="test/patches")
    parser.add_argument("--patch_ext", type=str, default="jpg")
    parser.add_argument("--map_path", type=str, default="test/output")
    parser.add_argument("--export_scores", type=int, default=0)
    parser.add_argument("--score_path", type=str, default="test/score")
    parser.add_argument("--average", action="store_true")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed for the per-class heatmap colors (the "
                             "reference draws them unseeded)")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--precision", default="f32",
                        choices=["bf16", "f32", "f32h", "f32x"],
                        help="Embedding precision; f32 matches the shipped "
                             "reference thresholds; bf16 runs the stem "
                             "kernel's bf16 route")
    parser.add_argument("--space_to_depth",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="Space-to-depth stem rewrite; moot for instance "
                             "norm at 224^2, whose stem is the fused kernel")
    parser.add_argument("--data_parallel", default=0, type=int, metavar="N",
                        help=DATA_PARALLEL_HELP)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    return parser.parse_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.class_name is None:
        args.class_name = [f"class {c}" for c in range(args.num_classes)]
    if len(args.thres) != args.num_classes:
        raise ValueError("Number of thresholds does not match classes.")
    return run_data_parallel(main, argv, args, "embedding",
                             lambda m: _run(args, m))


def _run(args, mesh) -> int:
    from tpumil_torch.infer.heatmap import BagInference, run_attention_maps
    from tpumil_torch.parallel.mesh import lead
    from tpumil_torch.utils.device import select_device

    emb, _, agg, model_name = load_milnet(
        args.embedder_weights, args.aggregator_weights, args.num_classes,
        select_device(args.device), backbone=args.backbone,
        precision=args.precision, space_to_depth=args.space_to_depth)
    infer = BagInference(emb, agg, batch_size=args.batch_size,
                         num_workers=args.num_workers, model=model_name,
                         mesh=mesh)

    def work():
        bags_list = sorted(glob.glob(os.path.join(args.bag_path, "*")))
        if args.export_scores:
            os.makedirs(args.score_path, exist_ok=True)
        run_attention_maps(
            infer, bags_list, args.thres, args.class_name, args.map_path,
            patch_ext=args.patch_ext,
            score_path=args.score_path if args.export_scores else None,
            average=args.average, seed=args.seed)

    lead(mesh, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
