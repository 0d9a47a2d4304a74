"""SimCLR pretraining CLI (counterpart of tpumil/cli/simclr_train.py, the
reference's simclr/run.py: manifest generation and config.yaml).

    python -m tpumil_torch.cli.simclr_train --device cuda --dataset <ds> \\
        --wsi_root <WSI> [--grad_cache 128] [--resume]

Patches are ``<wsi_root>/<dataset>/single/<class>/<bag>/*.jpeg`` (or the
pyramid layout with ``--multiscale 1``); the manifest is written to
``all_patches.csv`` in the working directory, and the run to
``runs/<dataset>-<level>/`` (``checkpoints/model.pth``, ``state/``,
``scalars.jsonl``). A reference-format YAML named by ``--config`` is read
when it exists (PyYAML is imported only then); flags override it.

``--data_parallel N`` trains on N devices, one process each (started here,
or by ``torchrun``): each rank decodes and augments its rows of every
batch, the projections are gathered for the full-batch loss and the
gradients averaged; rank 0 writes the manifest, the run and the log.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys


def generate_manifest(wsi_root: str, dataset: str, level: str,
                      multiscale: int):
    """all_patches.csv path globs (simclr/run.py:8-19)."""
    if multiscale == 1 and level == "high":
        pat = os.path.join(wsi_root, dataset, "pyramid", "*", "*", "*", "*.jpeg")
    elif multiscale == 1 and level == "low":
        pat = os.path.join(wsi_root, dataset, "pyramid", "*", "*", "*.jpeg")
    else:
        pat = os.path.join(wsi_root, dataset, "single", "*", "*", "*.jpeg")
    return sorted(glob.glob(pat))


def write_manifest(paths, path: str = "all_patches.csv") -> None:
    """The bytes of ``pd.DataFrame(paths).to_csv(path, index=False)``: a
    header ``0``, then one path per line (quoted only where csv needs it)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["0"])
        writer.writerows([p] for p in paths)


def _parser() -> argparse.ArgumentParser:
    from tpumil_torch.cli.attention_map import DATA_PARALLEL_HELP

    parser = argparse.ArgumentParser(
        description="SimCLR embedder pretraining (tpumil_torch)")
    parser.add_argument("--level", type=str, default="low", help="low|high")
    parser.add_argument("--multiscale", type=int, default=0)
    parser.add_argument("--dataset", type=str, default="TCGA-lung")
    parser.add_argument("--wsi_root", type=str, default=os.path.join("..", "WSI"))
    parser.add_argument("--config", type=str, default="config.yaml",
                        help="Reference-format YAML (optional; flags override)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None,
                        help="Learning rate (flag > config.yaml "
                             "learning_rate > 1e-5, simclr.py:72)")
    parser.add_argument("--temperature", type=float, default=None)
    parser.add_argument("--out_dim", type=int, default=None)
    parser.add_argument("--base_model", type=str, default=None)
    parser.add_argument("--run_dir", type=str, default=None)
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_parallel", type=int, default=0, metavar="N",
                        help=DATA_PARALLEL_HELP)
    parser.add_argument("--grad_cache", type=int, default=0,
                        help="Gradient-cache microbatch size: exact NT-Xent "
                             "gradients at O(microbatch) activation memory "
                             "(runs the reference's batch_size 4096 on one "
                             "card; 0 = monolithic step)")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted pretraining from the "
                             "train state under <run_dir>/state")
    parser.add_argument("--save_every_n_steps", type=int, default=0,
                        help="Also save crash-resume state every N train "
                             "steps (mid-epoch, exact continuation; 0 = "
                             "epoch-granularity saves only)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _read_config(path: str) -> dict:
    """The YAML at ``path`` if it exists, else {}; a missing PyYAML is an
    error, not an empty config."""
    if not (path and os.path.exists(path)):
        return {}
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"--config {path} needs PyYAML, which is not "
                          "installed") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def main(argv=None):
    from tpumil_torch.parallel import mesh

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.data_parallel < 0:
        raise ValueError(f"device count must be non-negative, got "
                         f"{args.data_parallel}")

    # config.yaml compatibility (simclr/run.py:28); parsed safely, no eval()
    cfg_yaml = _read_config(args.config)
    model_y = cfg_yaml.get("model", {})
    loss_y = cfg_yaml.get("loss", {})
    ds_y = cfg_yaml.get("dataset", {})

    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer, check_config)
    from tpumil_torch.utils.device import select_device

    model_cfg = SimCLRConfig(
        base_model=args.base_model or model_y.get("base_model", "resnet18"),
        out_dim=args.out_dim or model_y.get("out_dim", 256))
    train_cfg = SimCLRTrainConfig(
        batch_size=args.batch_size or cfg_yaml.get("batch_size", 512),
        epochs=args.epochs or cfg_yaml.get("epochs", 100),
        eval_every_n_epochs=cfg_yaml.get("eval_every_n_epochs", 1),
        lr=(args.lr if args.lr is not None
            else float(cfg_yaml.get("learning_rate", 1e-5))),
        weight_decay=float(str(cfg_yaml.get("weight_decay", "1e-5")).replace(
            "10e-6", "1e-5")),
        temperature=args.temperature or loss_y.get("temperature", 0.5),
        use_cosine_similarity=loss_y.get("use_cosine_similarity", True),
        valid_size=ds_y.get("valid_size", 0.1),
        s=float(ds_y.get("s", 1.0)),
        input_size=args.input_size,
        num_workers=args.num_workers,
        seed=args.seed,
        grad_cache_microbatch=args.grad_cache or None,
        save_every_n_steps=args.save_every_n_steps or None,
    )
    check_config(train_cfg, args.data_parallel or 1)
    if mesh.start_workers(main, argv, args.data_parallel, args.device):
        return 0
    with mesh.data_parallel(args.data_parallel, "pretraining",
                            args.device) as m:
        device = select_device(args.device)
        paths = generate_manifest(args.wsi_root, args.dataset, args.level,
                                  args.multiscale)
        if not paths:
            _parser().error(f"no patches found for dataset {args.dataset}")
        if mesh.is_main():
            # the manifest, for ecosystem parity (simclr/run.py:19-20)
            write_manifest(paths)
        run_dir = args.run_dir or os.path.join("runs",
                                               f"{args.dataset}-{args.level}")
        trainer = SimCLRTrainer(model_cfg, train_cfg, mesh=m, device=device)
        out = trainer.fit(paths, run_dir,
                          fine_tune_from=cfg_yaml.get("fine_tune_from") or None,
                          resume=args.resume)
        if mesh.is_main():
            print(f"best valid loss: {out['best_valid_loss']:.4f}; "
                  f"checkpoint: {out['checkpoint']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
