"""Train a MIL aggregator on the classic MIL benchmarks (musk1/2, elephant,
fox, tiger): the reference's train_mil.py:112-187 (counterpart of
tpumil/cli/train_mil.py).

    python -m tpumil_torch.cli.train_mil --device cuda --datasets musk1
    python -m tpumil_torch.cli.train_mil --device cpu \\
        --data_file tests/data/musk1_mini.svm --num_feats 166

``--datasets`` reads ``datasets/mil_dataset/<file>`` (data/mil_bench.py's
``DATASET_FILES``); ``--data_file`` with ``--num_feats`` overrides it.
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
                        help="MIL model [dsmil|abmil|meanpool|maxpool]")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--inst_shard", default=0, type=int, metavar="N",
                        help="Shard every bag's instance axis over N devices "
                             "(not ported yet: raises) [0 = off]")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    args = parser.parse_args(argv)
    if args.data_file and args.num_feats is None:
        parser.error("--num_feats is required with --data_file")
    if not args.data_file and args.datasets not in DATASET_FILES:
        parser.error(f"unknown dataset {args.datasets}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from tpumil_torch.train import schemes
    from tpumil_torch.utils.device import select_device

    device = select_device(args.device)
    print(f"device: {device}")
    if args.data_file:
        path, num_feats = args.data_file, args.num_feats
    else:
        rel, num_feats = DATASET_FILES[args.datasets]
        path = os.path.join("datasets", "mil_dataset", rel)
        if args.num_feats:
            num_feats = args.num_feats
    cfg = schemes.MILBenchConfig(
        num_feats=num_feats, lr=args.lr, num_epochs=args.num_epoch,
        cv_fold=args.cv_fold, weight_decay=args.weight_decay, seed=args.seed,
        model=args.model, inst_shard=args.inst_shard, device=device)
    # unknown models and unported modes raise before any file is read
    schemes._make_mil_trainer(cfg)

    print("Dataset: " + (args.data_file or args.datasets))
    bags = parse_mil_file(path, num_feats=num_feats)
    schemes.run_mil_cv(bags, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
