"""Train a MIL aggregator on the classic MIL benchmarks (musk1/2, elephant,
fox, tiger): the reference's train_mil.py:112-187 (counterpart of
tpumil/cli/train_mil.py).

    python -m tpumil_torch.cli.train_mil --device cuda --datasets musk1
    python -m tpumil_torch.cli.train_mil --device cpu \\
        --data_file tests/data/musk1_mini.svm --num_feats 166

``--datasets`` reads ``datasets/mil_dataset/<file>`` (data/mil_bench.py's
``DATASET_FILES``); ``--data_file`` with ``--num_feats`` overrides it.
``--inst_shard N`` with N > 1 runs on N devices, one process each, as
``train_wsi`` does: under ``torchrun``, or in N local workers that this
command starts itself; rank 0 logs.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpumil_torch.data.mil_bench import DATASET_FILES, parse_mil_file


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train DSMIL on classical MIL datasets (PyTorch port)")
    parser.add_argument("--datasets", default="musk1", type=str,
                        help="musk1, musk2, elephant, fox, tiger [musk1]")
    parser.add_argument("--data_file", default=None, type=str,
                        help="Explicit path to an svmlight-like MIL file "
                             "(overrides --datasets lookup)")
    parser.add_argument("--num_feats", default=None, type=int,
                        help="Feature count (required with --data_file)")
    parser.add_argument("--lr", default=2e-4, type=float,
                        help="Initial learning rate [0.0002]")
    parser.add_argument("--num_epoch", default=40, type=int,
                        help="Number of training epochs [40]")
    parser.add_argument("--cv_fold", default=10, type=int,
                        help="Cross validation folds [10]")
    parser.add_argument("--weight_decay", default=5e-3, type=float,
                        help="Weight decay [5e-3]")
    parser.add_argument("--model", default="dsmil", type=str,
                        help="MIL model "
                             "[dsmil|abmil|meanpool|maxpool|transmil]")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--inst_shard", default=0, type=int, metavar="N",
                        help="Shard every bag's instance axis over N devices "
                             "(power of two), one process each; the "
                             "single-device trajectory to float tolerance "
                             "[0 = off]")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    args = parser.parse_args(argv)
    if args.data_file and args.num_feats is None:
        parser.error("--num_feats is required with --data_file")
    if not args.data_file and args.datasets not in DATASET_FILES:
        parser.error(f"unknown dataset {args.datasets}")
    return args


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)

    from tpumil_torch.parallel import mesh
    from tpumil_torch.train import schemes
    from tpumil_torch.utils.device import select_device

    if mesh.needs_workers(args.inst_shard):
        # refusals and a too-small host fail here, before any worker starts
        schemes.check_mil_config(_config(args, None))
        mesh.take_devices(args.inst_shard, args.device)
        mesh.launch(main, args.inst_shard, (argv,), args.device)
        return 0
    if args.inst_shard:
        mesh.init_distributed(device_type=args.device)  # under a launcher
    log = print if mesh.is_main() else (lambda *a: None)
    device = select_device(args.device)
    log(f"device: {device}")
    cfg = _config(args, device)
    # unknown models and refused modes raise before any file is read
    schemes._make_mil_trainer(cfg)

    log("Dataset: " + (args.data_file or args.datasets))
    bags = parse_mil_file(_path(args), num_feats=cfg.num_feats)
    schemes.run_mil_cv(bags, cfg)
    return 0


def _path(args: argparse.Namespace) -> str:
    if args.data_file:
        return args.data_file
    return os.path.join("datasets", "mil_dataset",
                        DATASET_FILES[args.datasets][0])


def _config(args: argparse.Namespace, device):
    from tpumil_torch.train import schemes

    if args.data_file:
        num_feats = args.num_feats
    else:
        num_feats = args.num_feats or DATASET_FILES[args.datasets][1]
    return schemes.MILBenchConfig(
        num_feats=num_feats, lr=args.lr, num_epochs=args.num_epoch,
        cv_fold=args.cv_fold, weight_decay=args.weight_decay, seed=args.seed,
        model=args.model, inst_shard=args.inst_shard, device=device)


if __name__ == "__main__":
    sys.exit(main())
