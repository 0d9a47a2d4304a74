"""Train the DSMIL aggregator on precomputed WSI features: the reference's
train_tcga.py flags, eval schemes and outputs (counterpart of
tpumil/cli/train_wsi.py).

    python -m tpumil_torch.cli.train_wsi --device cuda --dataset <name> \\
        --num_classes 2 --eval_scheme 5-fold-cv

Reads ``datasets/<name>/<name>.csv`` (``datasets/tcga-dataset/TCGA.csv``
for TCGA-lung-default), caches the bags under ``--cache_dir`` and writes
``fold_{k}.pth``/``.json``/``.done.json`` under ``--save_root/<date>/``.

``--inst_shard N`` / ``--data_parallel N`` with N > 1 run on N devices, one
process each: under ``torchrun`` every process joins the launcher's group;
otherwise this command starts N local workers itself, each running the
same command on its own device (``cuda:r``, or the CPU with ``--device
cpu``). Rank 0 builds the bag cache and writes every output.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

SCHEMES = ("5-fold-cv", "5-time-train+valid+test", "5-fold-cv-standalone-test")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train DSMIL on patch features learned by SimCLR "
                    "(PyTorch port)")
    parser.add_argument("--num_classes", default=2, type=int,
                        help="Number of output classes [2]")
    parser.add_argument("--feats_size", default=512, type=int,
                        help="Dimension of the feature size [512]")
    parser.add_argument("--lr", default=0.0001, type=float,
                        help="Initial learning rate [0.0001]")
    parser.add_argument("--num_epochs", default=50, type=int,
                        help="Number of training epochs [50]")
    parser.add_argument("--stop_epochs", default=10, type=int,
                        help="Early stop after N epochs without improvement [10]")
    parser.add_argument("--weight_decay", default=1e-3, type=float,
                        help="Weight decay [1e-3]")
    parser.add_argument("--dataset", default="TCGA-lung-default", type=str,
                        help="Dataset folder name")
    parser.add_argument("--split", default=0.2, type=float,
                        help="Test split fraction [0.2]")
    parser.add_argument("--model", default="dsmil", type=str,
                        help="MIL model "
                             "[dsmil|abmil|meanpool|maxpool|transmil]")
    parser.add_argument("--dropout_patch", default=0, type=float,
                        help="Patch dropout rate [0]")
    parser.add_argument("--dropout_node", default=0, type=float,
                        help="Bag classifier dropout rate [0]")
    parser.add_argument("--non_linearity", default=1, type=float,
                        help="Additional nonlinear operation [1]")
    parser.add_argument("--average", action="store_true",
                        help="Average the score of max-pooling and bag aggregating")
    parser.add_argument("--eval_scheme", default="5-fold-cv", type=str,
                        help="[5-fold-cv | 5-fold-cv-standalone-test | "
                             "5-time-train+valid+test]")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda without a card raises")
    parser.add_argument("--cache_dir", default="temp_train", type=str)
    parser.add_argument("--save_root", default="weights", type=str)
    parser.add_argument("--eval_interval", default=1, type=int,
                        help="Evaluate every N epochs [1]")
    parser.add_argument("--resume", action="store_true",
                        help="Skip folds already completed in the save dir "
                             "(and continue a crashed fold mid-run when "
                             "--fold_state_every saved its train state)")
    parser.add_argument("--fold_state_every", type=int, default=0,
                        help="Checkpoint the full in-fold train state every "
                             "N eval boundaries for exact mid-fold crash "
                             "resume (0 = fold-granularity resume only)")
    parser.add_argument("--gpu_index", type=int, nargs="+", default=(0,),
                        help="Accepted for reference CLI compatibility "
                             "(train_tcga.py --gpu_index); device selection "
                             "here is --device")
    parser.add_argument("--inst_shard", default=0, type=int, metavar="N",
                        help="Shard every bag's instance axis over N devices "
                             "(power of two), one process each; the "
                             "single-device trajectory to float tolerance "
                             "[0 = off]")
    parser.add_argument("--data_parallel", default=0, type=int, metavar="N",
                        help="Minibatch training over a (data, inst) mesh of "
                             "N devices: one Adam step per chunk of bags, a "
                             "documented deviation from the reference's "
                             "per-bag steps. Mutually exclusive with "
                             "--inst_shard [0 = off]")
    args = parser.parse_args(argv)
    if args.inst_shard and args.data_parallel:
        parser.error("--inst_shard and --data_parallel are mutually "
                     "exclusive (per-bag vs minibatch optimization)")
    if args.eval_scheme not in SCHEMES:
        parser.error(f"unknown eval scheme {args.eval_scheme}")
    return args


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)

    from tpumil_torch.data.feature_store import BagCache, read_master_csv
    from tpumil_torch.parallel import mesh
    from tpumil_torch.train import schemes
    from tpumil_torch.utils.device import select_device

    n = args.inst_shard or args.data_parallel
    if mesh.needs_workers(n):
        # refusals and a too-small host fail here, before any worker starts
        schemes.check_config(_config(args, None))
        mesh.take_devices(n, args.device)
        mesh.launch(main, n, (argv,), args.device)
        return 0
    if n:
        mesh.init_distributed(device_type=args.device)  # under a launcher
    log = print if mesh.is_main() else (lambda *a: None)
    log(args.eval_scheme)
    device = select_device(args.device)
    log(f"device: {device}")

    cfg = _config(args, device)
    # unknown models and refused modes raise before any file is touched
    schemes._make_trainer(cfg)

    if args.dataset == "TCGA-lung-default":
        bags_csv = os.path.join("datasets", "tcga-dataset", "TCGA.csv")
    else:
        bags_csv = os.path.join("datasets", args.dataset, args.dataset + ".csv")
    cache = BagCache(args.cache_dir)
    if mesh.is_main():
        print("Creating intermediate training files.")
        cache.build(read_master_csv(bags_csv), args.num_classes,
                    dataset=args.dataset, seed=args.seed,
                    log=lambda s: sys.stdout.write(s))
    mesh.barrier()
    bags = cache.load_all()

    save_dir = os.path.join(args.save_root,
                            datetime.date.today().strftime("%Y%m%d"))
    run = {"5-fold-cv": schemes.run_5fold_cv,
           "5-time-train+valid+test": schemes.run_5time_tvt,
           "5-fold-cv-standalone-test":
               schemes.run_5fold_cv_standalone_test}[args.eval_scheme]
    run(bags, cfg, save_dir=save_dir)
    return 0


def _config(args: argparse.Namespace, device):
    from tpumil_torch.train import schemes

    return schemes.WSITrainConfig(
        feats_size=args.feats_size, num_classes=args.num_classes, lr=args.lr,
        num_epochs=args.num_epochs, stop_epochs=args.stop_epochs,
        weight_decay=args.weight_decay, split=args.split,
        dropout_patch=args.dropout_patch, dropout_node=args.dropout_node,
        nonlinear=bool(args.non_linearity), average=args.average,
        seed=args.seed, model=args.model, eval_interval=args.eval_interval,
        resume=args.resume, fold_state_every=args.fold_state_every or None,
        inst_shard=args.inst_shard, data_parallel=args.data_parallel,
        device=device)


if __name__ == "__main__":
    sys.exit(main())
