"""Single-config pipeline (counterpart of tpumil/cli/pipeline.py): run
any subset of the five stages from one typed YAML
(tpumil_torch.io.config.PipelineConfig, the JAX package's YAML keys):

    python -m tpumil_torch.cli.pipeline --config exp.yaml \\
        --stages tile,simclr,feats,train,maps [--device cuda|cpu]

tile (data/tiler) -> simclr (SimCLRTrainer) -> feats (cli/compute_feats) ->
train (5-fold-cv-standalone-test over the bag cache) -> maps (BagInference,
run_attention_maps): ``--device`` (default cuda, which raises without a
card) reaches every stage. ``train.inst_shard`` / ``train.data_parallel``
N > 1 run the train stage on N devices, one process each, as the train_wsi
CLI does: in N local workers that this command starts after building the
bag cache, or, under ``torchrun``, on the launcher's ranks (then the train
stage is the only one). ``embedder.data_parallel`` N > 0 splits the feats
and maps stages' patch batches over N devices: the feats stage passes
``--data_parallel N`` to compute_feats, and the maps stage runs
``BagInference(mesh=...)``, in N local workers for N > 1. Every check, the
device probe included, runs before the first stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys

STAGES = ("tile", "simclr", "feats", "train", "maps")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tpumil pipeline (PyTorch port)")
    parser.add_argument("--config", required=True, help="PipelineConfig YAML")
    parser.add_argument("--stages", default="tile,simclr,feats,train",
                        help=f"comma-separated subset of {STAGES}")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    parser.add_argument("--run_root", default="runs")
    return parser


def validate(parser: argparse.ArgumentParser, cfg, stages,
             device: str) -> None:
    """Every check that can fail a later stage, before the first one runs
    (the train and maps stages run after hours of tiling and pretraining):
    the JAX pipeline's checks and messages, and the probe of the devices
    that the embedding and train stages ask for."""
    for s in stages:
        if s not in STAGES:
            parser.error(f"unknown stage {s!r}; valid: {STAGES}")
    dp = cfg.embedder.data_parallel
    if dp:
        if dp < 0:
            parser.error(f"embedder.data_parallel must be >= 0, got {dp}")
        if "feats" in stages and cfg.embedder.batch_size % dp:
            parser.error(
                f"embedder.batch_size {cfg.embedder.batch_size} must divide "
                f"by embedder.data_parallel {dp} (feats stage)")
        if "maps" in stages and cfg.inference.batch_size % dp:
            parser.error(
                f"inference.batch_size {cfg.inference.batch_size} must divide "
                f"by embedder.data_parallel {dp} (maps stage shards patch "
                f"batches over the same mesh as feats)")
    device_asks = []
    if dp and ("feats" in stages or "maps" in stages):
        device_asks.append(("embedder.data_parallel", dp))
    if "train" in stages:
        if cfg.train.inst_shard and cfg.train.data_parallel:
            parser.error("train.inst_shard and train.data_parallel are "
                         "mutually exclusive (per-bag vs minibatch "
                         "optimization)")
        for name, val in (("train.inst_shard", cfg.train.inst_shard),
                          ("train.data_parallel", cfg.train.data_parallel)):
            if val < 0:
                parser.error(f"{name} must be >= 0, got {val}")
            if val:
                device_asks.append((name, val))
    from tpumil_torch.parallel.mesh import take_devices

    for name, val in device_asks:
        try:
            take_devices(val, device)
        except ValueError as exc:
            parser.error(f"{name}: {exc}")
    if "WORLD_SIZE" in os.environ and not (
            stages == ["train"]
            and (cfg.train.inst_shard or cfg.train.data_parallel)):
        parser.error("under a launcher the pipeline runs only the train "
                     "stage, with train.inst_shard or train.data_parallel; "
                     "run the other stages in one process")


def _embedder_weights(cfg, run_dir: str, simclr_ckpt):
    """embedder.weights, else this run's SimCLR checkpoint, else the last
    one under the run's simclr/checkpoints."""
    weights = cfg.embedder.weights or simclr_ckpt
    if weights is None:
        cands = sorted(glob.glob(os.path.join(run_dir, "simclr",
                                              "checkpoints", "*.pth")))
        weights = cands[-1] if cands else None
    if weights is None:
        raise SystemExit("no embedder weights; run the simclr stage or set "
                         "embedder.weights")
    return weights


def maps_stage(cfg, run_dir: str, device: str, embedder_weights: str,
               aggregator_weights: str) -> None:
    """Attention maps of every bag into ``<run_dir>/maps`` (and
    ``<run_dir>/scores``), the patch batches split over
    ``embedder.data_parallel`` ranks when it is set (this process is one
    of them; rank 0 writes)."""
    from tpumil_torch.cli.attention_map import load_milnet
    from tpumil_torch.infer.heatmap import BagInference, run_attention_maps
    from tpumil_torch.parallel import mesh
    from tpumil_torch.utils.device import select_device

    with mesh.data_parallel(cfg.embedder.data_parallel, "embedding",
                            device) as m:
        embedder, _, aggregator, model_name = load_milnet(
            embedder_weights, aggregator_weights, cfg.train.num_classes,
            select_device(device), cfg.embedder.norm_layer,
            backbone=cfg.embedder.backbone, precision=cfg.embedder.precision,
            # the SAME stem the feats stage embedded (and the aggregator
            # trained on)
            space_to_depth=cfg.embedder.space_to_depth)
        infer = BagInference(embedder, aggregator,
                             batch_size=cfg.inference.batch_size,
                             patch_size=cfg.embedder.patch_size,
                             num_workers=cfg.inference.num_workers,
                             model=model_name, mesh=m)
        layout = "pyramid" if len(cfg.magnifications) > 1 else "single"
        bags_list = sorted(glob.glob(os.path.join(cfg.wsi_root, cfg.dataset,
                                                  layout, "*", "*")))
        thres = cfg.inference.thresholds or [0.5] * cfg.train.num_classes
        names = cfg.inference.class_names or [
            f"class {c}" for c in range(cfg.train.num_classes)]
        mesh.lead(m, lambda: run_attention_maps(
            infer, bags_list, thres, names, os.path.join(run_dir, "maps"),
            # tiles were written by the tiler stage in cfg.tiler.format
            patch_ext=cfg.inference.patch_ext or cfg.tiler.format,
            score_path=os.path.join(run_dir, "scores")
            if cfg.inference.export_scores else None,
            average=cfg.inference.average, seed=cfg.train.seed))


def train_stage(train_cfg, run_dir: str, device: str) -> None:
    """5-fold-cv-standalone-test over the run's bag cache into
    ``<run_dir>/weights``, on this process's device (one rank of the
    train stage's process group when it has one)."""
    from tpumil_torch.data.feature_store import BagCache
    from tpumil_torch.train import schemes
    from tpumil_torch.utils.device import select_device

    schemes.run_5fold_cv_standalone_test(
        BagCache(os.path.join(run_dir, "bag_cache")).load_all(),
        dataclasses.replace(train_cfg, device=select_device(device)),
        save_dir=os.path.join(run_dir, "weights"))


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from tpumil_torch.io.config import PipelineConfig

    cfg = PipelineConfig.from_yaml(args.config)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    validate(parser, cfg, stages, args.device)

    from tpumil_torch.parallel import mesh
    from tpumil_torch.utils.device import select_device

    mesh.init_distributed(device_type=args.device)  # under a launcher only
    device = select_device(args.device)
    run_dir = os.path.join(args.run_root, cfg.dataset)
    if mesh.is_main():
        os.makedirs(run_dir, exist_ok=True)
        cfg.to_yaml(os.path.join(run_dir, "resolved_config.yaml"))

    simclr_ckpt = None
    if "tile" in stages:
        from tpumil_torch.data.tiler import tile_dataset

        print(f"== stage: tile ({cfg.dataset}, mags {cfg.magnifications})")
        tile_dataset(cfg.wsi_root, cfg.dataset, cfg.magnifications, cfg.tiler,
                     slide_format="svs")
        # also pick up .tif slides like the reference's glob patterns
        tile_dataset(cfg.wsi_root, cfg.dataset, cfg.magnifications, cfg.tiler,
                     slide_format="tif")

    if "simclr" in stages:
        from tpumil_torch.cli.simclr_train import generate_manifest
        from tpumil_torch.models.simclr import SimCLRConfig
        from tpumil_torch.train.simclr_trainer import SimCLRTrainer

        print("== stage: simclr")
        multiscale = 1 if len(cfg.magnifications) > 1 else 0
        # level is only consulted for multiscale manifests (simclr/run.py:8-19)
        paths = generate_manifest(cfg.wsi_root, cfg.dataset, "low", multiscale)
        if not paths:
            raise SystemExit("no patches found; run the tile stage first")
        if cfg.embedder.backbone not in ("resnet18", "resnet50"):
            raise SystemExit(
                f"SimCLR pretraining supports resnet18/resnet50 (the reference "
                f"too, simclr/models/resnet_simclr.py:10-11); configured "
                f"embedder.backbone={cfg.embedder.backbone!r} would not load "
                f"back positionally. Set embedder.weights to pretrain elsewhere.")
        trainer = SimCLRTrainer(SimCLRConfig(base_model=cfg.embedder.backbone),
                                cfg.simclr, device=device)
        out = trainer.fit(paths, os.path.join(run_dir, "simclr"))
        simclr_ckpt = out["checkpoint"]

    if "feats" in stages:
        print("== stage: feats")
        weights = _embedder_weights(cfg, run_dir, simclr_ckpt)
        from tpumil_torch.cli import compute_feats as cf

        cf_args = ["--dataset", cfg.dataset, "--num_classes",
                   str(cfg.embedder.num_classes), "--batch_size",
                   str(cfg.embedder.batch_size), "--num_workers",
                   str(cfg.embedder.num_workers), "--backbone",
                   cfg.embedder.backbone, "--norm_layer", cfg.embedder.norm_layer,
                   "--magnification", cfg.embedder.magnification,
                   "--weights", weights, "--wsi_root", cfg.wsi_root,
                   "--out_root", cfg.datasets_root, "--patch_size",
                   str(cfg.embedder.patch_size), "--precision",
                   cfg.embedder.precision, "--tree_fusion",
                   cfg.embedder.tree_fusion, "--device", args.device]
        if not cfg.embedder.space_to_depth:
            cf_args += ["--no-space_to_depth"]
        if cfg.embedder.data_parallel:
            cf_args += ["--data_parallel", str(cfg.embedder.data_parallel)]
        if cfg.embedder.weights_high:
            cf_args += ["--weights_high", cfg.embedder.weights_high]
        if cfg.embedder.weights_low:
            cf_args += ["--weights_low", cfg.embedder.weights_low]
        cf.main(cf_args)

    if "train" in stages:
        from tpumil_torch.data.feature_store import BagCache, read_master_csv

        n = cfg.train.inst_shard or cfg.train.data_parallel
        if mesh.is_main():
            print(f"== stage: train ({cfg.train.model}, "
                  f"{cfg.train.num_epochs} epochs)")
            bags_csv = os.path.join(cfg.datasets_root, cfg.dataset,
                                    cfg.dataset + ".csv")
            BagCache(os.path.join(run_dir, "bag_cache")).build(
                read_master_csv(bags_csv), cfg.train.num_classes,
                dataset=cfg.dataset, seed=cfg.train.seed)
        mesh.barrier()
        if mesh.needs_workers(n):
            if device.type == "cuda":
                import torch

                torch.cuda.empty_cache()  # worker 0 trains on this card
            mesh.launch(train_stage, n, (cfg.train, run_dir, args.device),
                        args.device)
        else:
            train_stage(cfg.train, run_dir, args.device)

    if "maps" in stages:
        print("== stage: maps")
        agg = sorted(glob.glob(os.path.join(run_dir, "weights", "fold_*.pth")))
        if not agg:
            raise SystemExit("no trained aggregator; run the train stage first")
        maps_args = (cfg, run_dir, args.device,
                     _embedder_weights(cfg, run_dir, simclr_ckpt), agg[0])
        if mesh.needs_workers(cfg.embedder.data_parallel):
            if device.type == "cuda":
                import torch

                torch.cuda.empty_cache()  # worker 0 embeds on this card
            mesh.launch(maps_stage, cfg.embedder.data_parallel, maps_args,
                        args.device)
        else:
            maps_stage(*maps_args)
    print("pipeline done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
