"""Evaluation schemes (counterpart of tpumil/train/schemes.py): the
classic-MIL k-fold CV of train_mil.py (``run_mil_cv``) and the three WSI
schemes of train_tcga.py over precomputed feature bags, 5-fold-cv,
5-time-train+valid+test and 5-fold-cv-standalone-test, with fold and
iteration markers for ``--resume`` and mid-fold train state. Every scheme
trains any registry model, on one device or, with ``inst_shard`` /
``data_parallel``, on every rank of a process group (parallel/).

Every host RNG stream is the JAX package's: the same seeds, the same
draws, in the same order, so a run visits the same bags in the same order
(torch's dropout streams differ from JAX's). The per-fold parameter init
is drawn from ``torch.Generator().manual_seed(cfg.seed + fold)`` (WSI) or
``manual_seed(cfg.seed + 1000 * fold)`` (``run_mil_cv``), where the JAX
package draws from ``PRNGKey`` of the same number.

On a process group every rank trains and evaluates, as the JAX package's
single controller does once; the decisions (best score, early stop,
thresholds) are rank 0's values, broadcast, so that a last-bit difference
between devices cannot split the ranks' control flow; only rank 0 logs and
writes, and every rank reads the resume markers after a barrier.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.data.mil_bench import (
    compute_pos_weight,
    cross_validation_split,
    shuffle_with_class_coverage,
)
from tpumil_torch.io import native_ckpt, torch_ckpt
from tpumil_torch.models import dsmil
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.registry import get_model, require_instance_stream
from tpumil_torch.parallel.mesh import (barrier, broadcast_from_main,
                                        default_inst_parallel, is_main,
                                        make_mesh)
from tpumil_torch.train import metrics
from tpumil_torch.train.optim import cosine_annealing_lr
from tpumil_torch.train.trainer import BagTrainer


# ---------------------------------------------------------------------------
# Classic MIL benchmarks (train_mil.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MILBenchConfig:
    num_feats: int
    lr: float = 2e-4                  # train_mil.py:115
    num_epochs: int = 40              # train_mil.py:116
    cv_fold: int = 10                 # train_mil.py:117
    weight_decay: float = 5e-3        # train_mil.py:118
    seed: int = 0
    verbose: bool = True
    model: str = "dsmil"              # train_mil.py:119
    # keep the dataset on the device as one flat tensor, folds as device
    # gathers; False keeps the bags on the host
    use_device_store: bool = True
    # "orthogonal" (the framework's one init, train_tcga.py:229-233) or
    # "torch_default" (nn.Linear/Conv1d defaults, what train_mil.py trains
    # with; dsmil only)
    init: str = "orthogonal"
    # split every bag's rows over N devices (parallel/bag_shard.py; the
    # same trajectory as one device, to float tolerance); 0 = one device
    inst_shard: int = 0
    # None: the card; BagTrainer resolves it (and raises without one)
    device: Optional[torch.device] = None


def check_mil_config(cfg: MILBenchConfig) -> None:
    """Every refusal of ``run_mil_cv`` that needs no data and no process
    group (an unknown ``init``, ``torch_default`` for a model other than
    dsmil, an ``inst_shard`` the sharded trainer refuses)."""
    if cfg.init not in ("orthogonal", "torch_default"):
        # a typo ("torch-default", "default") must not silently measure
        # orthogonal init under the wrong name
        raise ValueError(f"init must be 'orthogonal' or 'torch_default', "
                         f"got {cfg.init!r}")
    if cfg.init == "torch_default" and cfg.model != "dsmil":
        raise ValueError(
            f"init='torch_default' is only implemented for model='dsmil' "
            f"(got {cfg.model!r}); use init='orthogonal'")
    if cfg.inst_shard:
        from tpumil_torch.parallel.bag_shard import check_inst_shard

        check_inst_shard(cfg.inst_shard,
                         DSMILConfig(feats_size=cfg.num_feats, num_classes=1),
                         cfg.model, 0.0)


def _make_mil_trainer(cfg: MILBenchConfig) -> BagTrainer:
    """The one trainer of every fold; raises as :func:`check_mil_config`,
    before any data moves."""
    check_mil_config(cfg)
    model_cfg = DSMILConfig(feats_size=cfg.num_feats, num_classes=1)
    if cfg.inst_shard:
        from tpumil_torch.parallel.bag_shard import InstanceShardedBagTrainer

        return InstanceShardedBagTrainer(
            model_cfg, weight_decay=cfg.weight_decay, model=cfg.model,
            device=cfg.device, mesh=_mesh(cfg.inst_shard, cfg.inst_shard,
                                          cfg.device))
    return BagTrainer(model_cfg, weight_decay=cfg.weight_decay,
                      model=cfg.model, device=cfg.device)


def _mesh(n: int, inst: int, device: Optional[torch.device]):
    """A mesh of ``n`` ranks with ``inst`` on the instance axis, on the
    device type of ``device`` (None: the card)."""
    return make_mesh(n, inst, "cuda" if device is None else device.type)


def run_mil_cv(bags: List[Bag], cfg: MILBenchConfig,
               log: Callable[[str], None] = print,
               permutation: Optional[Sequence[int]] = None,
               ) -> Tuple[float, float, List[float]]:
    """k-fold CV on a classic MIL dataset (train_mil.py:164-187). Per fold:
    a fresh model, Adam with the fold's pos_weight'd BCE, cosine LR to 0,
    the best epoch accuracy kept. Returns (mean_acc, std_acc,
    per_fold_accs).

    The bags are shuffled until every test split holds a positive bag, or
    put in the order of ``permutation``; the folds are contiguous chunks of
    that order, and every epoch visits one fixed post-split order
    (``shuffle=False``), as the reference's epoch_train does. The
    reference's per-epoch shuffle of each bag's instance rows is omitted:
    every registry model is invariant to it."""
    trainer = _make_mil_trainer(cfg)
    log = _main_log(log)
    rng = np.random.default_rng(cfg.seed)
    if permutation is not None:
        if sorted(permutation) != list(range(len(bags))):
            raise ValueError("permutation must be a permutation of range(n_bags)")
        bags = [bags[i] for i in permutation]
    else:
        bags = shuffle_with_class_coverage(list(bags), cfg.cv_fold, rng)
    lr_of = cosine_annealing_lr(cfg.lr, cfg.num_epochs, 0.0)
    accs = []
    indices = list(range(len(bags)))
    # the dataset moves to the device once; folds are device gathers
    store = _global_store(bags, cfg, trainer)
    for k in range(cfg.cv_fold):
        tr_idx, te_idx = cross_validation_split(indices, cfg.cv_fold, k)
        trainer.pos_weight = np.asarray(
            [compute_pos_weight([bags[i] for i in tr_idx])], np.float32)
        generator = torch.Generator().manual_seed(cfg.seed + 1000 * k)
        if cfg.init == "torch_default":
            net = dsmil.torch_default_init_params(generator, trainer.cfg,
                                                  trainer.device)
            opt = trainer.make_optimizer(net)
        else:
            net, opt = trainer.init(generator)
        best_acc = 0.0
        labels = np.asarray([float(bags[i].label[0]) for i in te_idx])
        train_bags, test_bags = _fold_views(store, bags, tr_idx, te_idx)
        for epoch in range(cfg.num_epochs):
            net, opt, train_loss = trainer.train_epoch(
                net, opt, train_bags, lr_of(epoch), rng, shuffle=False)
            scores, losses = trainer.predict(net, test_bags)
            acc, auc, prec, rec, f1 = metrics.five_scores(labels, scores[:, 0])
            best_acc = max(best_acc, acc)
            if cfg.verbose:
                log(f" fold {k} epoch {epoch + 1}/{cfg.num_epochs} "
                    f"train_loss {train_loss:.4f} test_loss {float(np.mean(losses)):.4f} "
                    f"acc {acc:.4f} auc {auc:.4f} p {prec:.4f} r {rec:.4f} f1 {f1:.4f}")
        log(f" fold {k} optimal accuracy: {best_acc:.4f}")
        accs.append(best_acc)
    mean, std = float(np.mean(accs)), float(np.std(accs))
    log(f"Cross validation accuracy mean: {mean:.4f}, std {std:.4f}")
    return mean, std, accs


# ---------------------------------------------------------------------------
# WSI schemes (train_tcga.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WSITrainConfig:
    feats_size: int = 512             # train_tcga.py:202
    num_classes: int = 2              # train_tcga.py:201
    lr: float = 1e-4                  # train_tcga.py:203
    num_epochs: int = 50              # train_tcga.py:204
    stop_epochs: int = 10             # train_tcga.py:205
    weight_decay: float = 1e-3        # train_tcga.py:207
    split: float = 0.2                # train_tcga.py:209
    dropout_patch: float = 0.0        # train_tcga.py:211
    dropout_node: float = 0.0         # train_tcga.py:212
    nonlinear: bool = True            # train_tcga.py:213
    average: bool = False             # train_tcga.py:214
    eta_min: float = 5e-6             # train_tcga.py:242
    seed: int = 0
    verbose: bool = True
    model: str = "dsmil"              # train_tcga.py:210
    # keep each split's bags on the device as one flat tensor (no per-step
    # host->device feature traffic)
    use_device_store: bool = True
    # evaluate (and early-stop-check) every N epochs; 1 = the reference's
    # cadence. N > 1 draws the host RNG as BagTrainer.train_epochs does.
    eval_interval: int = 1
    # skip folds whose completion marker exists in the save dir
    resume: bool = False
    # also save the full in-fold train state every N eval boundaries, so a
    # crash resumes mid-fold on the exact trajectory (with resume=True)
    fold_state_every: Optional[int] = None
    # split every bag's rows over N devices (parallel/bag_shard.py): the
    # single-device trajectory to float tolerance, so NOT part of the
    # experiment fingerprint (a run may resume on another shard count)
    inst_shard: int = 0
    # one minibatch Adam step per chunk of bags over a (data, inst) mesh of
    # N devices (parallel/sharded_train.py): a documented deviation from
    # the reference's per-bag steps, so part of the fingerprint; exclusive
    # with inst_shard
    data_parallel: int = 0
    # None: the card; BagTrainer resolves it (and raises without one)
    device: Optional[torch.device] = None


def _model_cfg(cfg: WSITrainConfig) -> DSMILConfig:
    return DSMILConfig(feats_size=cfg.feats_size, num_classes=cfg.num_classes,
                       nonlinear=cfg.nonlinear, dropout_v=cfg.dropout_node)


def check_config(cfg: WSITrainConfig) -> None:
    """The refusals of the multi-device modes that need no data and no
    process group, so that a CLI raises them before it starts workers."""
    if cfg.inst_shard and cfg.data_parallel:
        raise ValueError("inst_shard and data_parallel are mutually "
                         "exclusive (per-bag vs minibatch optimization)")
    mil = get_model(cfg.model)  # unknown names raise here
    if cfg.average and mil.objective != "dual_stream":
        raise ValueError(f"--average adds the max instance score; model "
                         f"{cfg.model!r} has no instance stream")
    if cfg.inst_shard:
        from tpumil_torch.parallel.bag_shard import check_inst_shard

        check_inst_shard(cfg.inst_shard, _model_cfg(cfg), cfg.model,
                         cfg.dropout_patch)
    if cfg.data_parallel:
        from tpumil_torch.parallel.sharded_train import check_data_parallel

        require_instance_stream(cfg.model, "--data_parallel")
        sp = default_inst_parallel(cfg.data_parallel)
        check_data_parallel(cfg.data_parallel // sp, sp, cfg.dropout_patch)


def _make_trainer(cfg: WSITrainConfig) -> BagTrainer:
    check_config(cfg)
    kw = dict(weight_decay=cfg.weight_decay, dropout_patch=cfg.dropout_patch,
              model=cfg.model, device=cfg.device)
    if cfg.inst_shard:
        from tpumil_torch.parallel.bag_shard import InstanceShardedBagTrainer

        return InstanceShardedBagTrainer(
            _model_cfg(cfg), mesh=_mesh(cfg.inst_shard, cfg.inst_shard,
                                        cfg.device), **kw)
    if cfg.data_parallel:
        from tpumil_torch.parallel.sharded_train import DataParallelBagTrainer

        return DataParallelBagTrainer(
            _model_cfg(cfg), mesh=_mesh(
                cfg.data_parallel, default_inst_parallel(cfg.data_parallel),
                cfg.device), **kw)
    return BagTrainer(_model_cfg(cfg), **kw)


def _main_log(log: Callable[[str], None]) -> Callable[[str], None]:
    """``log`` on rank 0, silence on the others."""
    return log if is_main() else (lambda s: None)


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _load(trainer: BagTrainer, params: Dict[str, torch.Tensor]
          ) -> torch.nn.Module:
    model = get_model(trainer.model)(trainer.cfg, trainer.device)
    model.load_state_dict(params, strict=True)
    return model


def evaluate_bags(trainer: BagTrainer, model: torch.nn.Module, bags,
                  cfg: WSITrainConfig, thresholds: Optional[List[float]] = None,
                  rng: Optional[np.random.Generator] = None):
    """The reference's ``test()``: scores, AUCs, optimal (or given)
    thresholds, binarised predictions and exact-match accuracy. ``bags``
    is a Sequence[Bag] or a DeviceBagStore."""
    if isinstance(bags, DeviceBagStore):
        labels = bags.labels
    else:
        labels = np.stack([np.atleast_1d(b.label) for b in bags])
    scores, losses = trainer.predict(model, bags, average=cfg.average, rng=rng)
    aucs, _, thresholds_optimal = metrics.multi_label_roc(
        labels, scores, cfg.num_classes)
    if thresholds is not None:
        thresholds_optimal = list(thresholds)
    preds = metrics.binarize(
        scores if cfg.num_classes > 1 else scores[:, 0], thresholds_optimal)
    avg_score = metrics.exact_match_score(
        labels if cfg.num_classes > 1 else labels[:, 0], preds)
    return {
        "loss": float(np.mean(losses)),
        "avg_score": avg_score,
        "aucs": aucs,
        "thresholds_optimal": [float(t) for t in thresholds_optimal],
        "predictions": preds,
        "labels": labels if cfg.num_classes > 1 else labels[:, 0],
        "scores": scores,
    }


def _kfold_indices(n: int, n_splits: int, seed: int = 42):
    """``KFold(n_splits, shuffle=True, random_state=seed).split`` of
    ``range(n)``: a RandomState(seed) shuffle cut into folds, the first
    ``n % n_splits`` one longer; train and test indices ascending."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[:n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        out.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return out


def train_fold(trainer: BagTrainer, train_bags, test_bags,
               cfg: WSITrainConfig, rng: np.random.Generator,
               init_generator: torch.Generator,
               log: Callable[[str], None] = print,
               save_cb: Optional[Callable] = None,
               state_dir: Optional[str] = None,
               state_fp: Optional[str] = None):
    """One fold: train with early stopping on the reference's selection
    criterion ``(sum(aucs) + acc) / 2``. Returns the best
    ``{"score", "params" (a state_dict), "thresholds", "acc", "aucs"}``.

    With ``state_dir`` and ``cfg.fold_state_every`` the whole train state
    (parameters, Adam state, best so far, host RNG state) is saved every N
    eval boundaries and, with ``cfg.resume``, restored at fold start when
    its fingerprint is ``state_fp``: the continuation is the uninterrupted
    trajectory."""
    if cfg.use_device_store:
        min_bucket = _required_min_bucket(cfg)
        if not isinstance(train_bags, DeviceBagStore):
            train_bags = DeviceBagStore(train_bags, min_bucket,
                                        device=trainer.device)
        if not isinstance(test_bags, DeviceBagStore):
            test_bags = DeviceBagStore(test_bags, min_bucket,
                                       device=trainer.device)
    model, opt = trainer.init(init_generator)
    lr_of = cosine_annealing_lr(cfg.lr, cfg.num_epochs, cfg.eta_min)
    # valid defaults, so that a fold that never clears score 0 still exports
    # usable weights and thresholds
    best = {"score": 0.0, "params": _snapshot(model),
            "thresholds": [0.5] * cfg.num_classes, "acc": 0.0,
            "aucs": [0.0] * cfg.num_classes}
    counter = 0
    epoch = 1
    boundaries = 0
    if state_dir and cfg.resume and (os.path.isdir(state_dir)
                                     or os.path.isdir(state_dir + ".prev")):
        try:
            st, meta = native_ckpt.load_sharded_train_state(
                state_dir, trainer.device)
        except (OSError, RuntimeError, ValueError, KeyError,
                pickle.UnpicklingError) as e:  # unreadable: fresh fold
            st, meta = None, {"fingerprint": f"<unreadable: {e}>"}
        if st is not None and meta.get("fingerprint") == state_fp:
            model.load_state_dict(st["params"])
            opt.load_state_dict(st["opt_state"])
            best = {"score": float(meta["best_score"]),
                    "params": st["best_params"],
                    "thresholds": list(meta["best_thresholds"]),
                    "acc": float(meta["best_acc"]),
                    "aucs": list(meta["best_aucs"])}
            counter = int(meta["counter"])
            epoch = int(meta["epoch"])
            boundaries = int(meta["boundaries"])
            rng.bit_generator.state = meta["rng_state"]
            log(f"Resuming fold mid-run at epoch {epoch} "
                f"(best score {best['score']:.4f}).")
        else:
            log("Existing fold state was produced by a different config; "
                "training the fold from scratch.")
    fused = cfg.eval_interval > 1 and isinstance(train_bags, DeviceBagStore)
    while epoch <= cfg.num_epochs:
        k = min(cfg.eval_interval, cfg.num_epochs - epoch + 1) if fused else 1
        counter += k
        if fused:
            lrs = [lr_of(e - 1) for e in range(epoch, epoch + k)]
            model, opt, losses = trainer.train_epochs(
                model, opt, train_bags, lrs, rng)
            train_loss = float(losses[-1])
        else:
            model, opt, train_loss = trainer.train_epoch(
                model, opt, train_bags, lr_of(epoch - 1), rng)
        epoch += k
        res = broadcast_from_main(_decisive(
            evaluate_bags(trainer, model, test_bags, cfg, rng=rng)))
        if cfg.verbose:
            auc_str = "|".join(f"class-{i}>>{a:.4f}"
                               for i, a in enumerate(res["aucs"]))
            log(f" epoch {epoch - 1}/{cfg.num_epochs} train loss: "
                f"{train_loss:.4f} test loss: {res['loss']:.4f} avg score: "
                f"{res['avg_score']:.4f} AUC: {auc_str}")
        score = metrics.current_score(res["avg_score"], res["aucs"])
        if score > best["score"]:
            counter = 0
            best = {"score": score, "params": _snapshot(model),
                    "thresholds": res["thresholds_optimal"],
                    "acc": res["avg_score"], "aucs": res["aucs"]}
            if save_cb is not None:
                save_cb(best["params"], best["thresholds"])
        boundaries += 1
        if (state_dir and cfg.fold_state_every
                and boundaries % cfg.fold_state_every == 0
                and epoch <= cfg.num_epochs and counter <= cfg.stop_epochs):
            native_ckpt.save_sharded_train_state(
                state_dir,
                {"params": model.state_dict(), "opt_state": opt.state_dict(),
                 "best_params": best["params"]},
                meta={"fingerprint": state_fp,
                      "best_score": float(best["score"]),
                      "best_thresholds": [float(t) for t in best["thresholds"]],
                      "best_acc": float(best["acc"]),
                      "best_aucs": [float(a) for a in best["aucs"]],
                      "counter": int(counter), "epoch": int(epoch),
                      "boundaries": int(boundaries),
                      "rng_state": rng.bit_generator.state})
        if counter > cfg.stop_epochs:
            break
    # the mid-fold state stays: the caller's completion marker must be on
    # disk before it goes (_mark_fold_done / _mark_iteration_done)
    return best


def _decisive(res: dict) -> dict:
    """The values of an evaluation that decide what happens next."""
    return {k: res[k] for k in ("loss", "avg_score", "aucs",
                                "thresholds_optimal")}


def _required_min_bucket(cfg) -> int:
    """Smallest bucket a store may make for ``cfg`` (a WSITrainConfig or
    MILBenchConfig): the sharded trainers raise their min_bucket to the
    inst axis, and the store's buckets set the visitation order, which
    must be the trainer's."""
    n = 16  # DeviceBagStore's default
    if getattr(cfg, "inst_shard", 0):
        n = max(n, int(cfg.inst_shard))
    if getattr(cfg, "data_parallel", 0):
        n = max(n, default_inst_parallel(cfg.data_parallel))
    return n


def _global_store(bags, cfg, trainer: BagTrainer):
    """One device-resident store of the whole dataset, or None when
    ``cfg`` (a WSITrainConfig or MILBenchConfig) keeps the bags on the
    host; splits are device gathers (DeviceBagStore.subset). The trainer's
    "auto" route counts it as resident beside every split it trains."""
    if not cfg.use_device_store:
        return None
    store = DeviceBagStore(bags, _required_min_bucket(cfg),
                           device=trainer.device)
    trainer.extra_resident_bytes = store.nbytes()
    return store


def _fold_views(store, bags, tr_idx, te_idx):
    if store is not None:
        return store.subset(tr_idx), store.subset(te_idx)
    return [bags[i] for i in tr_idx], [bags[i] for i in te_idx]


def _fold_init(cfg: WSITrainConfig, fold: int) -> torch.Generator:
    return torch.Generator().manual_seed(cfg.seed + fold)


def run_5fold_cv(bags: List[Bag], cfg: WSITrainConfig,
                 log: Callable[[str], None] = print,
                 save_dir: Optional[str] = None) -> dict:
    """train_tcga.py:252-294."""
    trainer = _make_trainer(cfg)
    log = _main_log(log)
    store = _global_store(bags, cfg, trainer)
    scheme = "5-fold-cv"
    fold_results = []
    for fold, (tr_idx, te_idx) in enumerate(_kfold_indices(len(bags), 5)):
        resumed = _try_resume_fold(trainer, cfg, save_dir, fold, log, scheme)
        if resumed is not None:
            fold_results.append(resumed)
            continue
        log(f"Starting CV fold {fold}.")
        save_cb = _fold_saver(save_dir, fold, cfg.model) if save_dir else None
        tr, te = _fold_views(store, bags, tr_idx, te_idx)
        # a host RNG per fold: a resumed run's later folds draw what an
        # uninterrupted run draws
        best = train_fold(trainer, tr, te, cfg,
                          np.random.default_rng([cfg.seed, fold]),
                          _fold_init(cfg, fold), log, save_cb,
                          state_dir=_fold_state_dir(save_dir, fold),
                          state_fp=_cfg_fingerprint(cfg, scheme))
        _mark_fold_done(save_dir, fold, best, scheme, cfg)
        fold_results.append(best)
    mean_ac = float(np.mean([b["acc"] for b in fold_results]))
    mean_auc = np.mean(np.array([b["aucs"] for b in fold_results]), axis=0)
    log(f"Final results: Mean Accuracy: {mean_ac}")
    for i, a in enumerate(mean_auc):
        log(f"Class {i}: Mean AUC = {a:.4f}")
    return {"mean_accuracy": mean_ac, "mean_auc": [float(a) for a in mean_auc],
            "folds": [{"acc": b["acc"], "aucs": b["aucs"],
                       "thresholds": b["thresholds"]} for b in fold_results]}


def run_5time_tvt(bags: List[Bag], cfg: WSITrainConfig,
                  log: Callable[[str], None] = print,
                  save_dir: Optional[str] = None) -> dict:
    """train_tcga.py:297-348: 5 random train/valid/test splits, the model
    selected on valid and tested on the held-out test split with its
    thresholds. Each iteration draws from ``default_rng([seed, it])``;
    completed iterations resume from ``iter_{k}.done.json``."""
    scheme = "5-time-train+valid+test"
    trainer = _make_trainer(cfg)
    log = _main_log(log)
    store = _global_store(bags, cfg, trainer)
    results = []
    for it in range(5):
        resumed = _try_resume_iteration(cfg, save_dir, it, log, scheme)
        if resumed is not None:
            results.append(resumed)
            continue
        log(f"Starting iteration {it + 1}.")
        rng = np.random.default_rng([cfg.seed, it])
        order = rng.permutation(len(bags))
        n = len(bags)
        train_end = int(n * (1 - cfg.split - 0.1))
        val_end = train_end + int(n * 0.1)
        train_bags, val_bags = _fold_views(store, bags, order[:train_end],
                                           order[train_end:val_end])
        if store is not None:
            test_bags = store.subset(order[val_end:])
        else:
            test_bags = [bags[i] for i in order[val_end:]]
        save_cb = _fold_saver(save_dir, it, cfg.model) if save_dir else None
        best = train_fold(trainer, train_bags, val_bags, cfg, rng,
                          _fold_init(cfg, it), log, save_cb,
                          state_dir=_fold_state_dir(save_dir, it),
                          state_fp=_cfg_fingerprint(cfg, scheme))
        test_res = broadcast_from_main(_decisive(evaluate_bags(
            trainer, _load(trainer, best["params"]), test_bags, cfg,
            thresholds=best["thresholds"], rng=rng)))
        res = {"val_acc": best["acc"], "val_aucs": best["aucs"],
               "test_acc": test_res["avg_score"],
               "test_aucs": test_res["aucs"]}
        _mark_iteration_done(save_dir, it, res, scheme, cfg)
        results.append(res)
    mean_ac = float(np.mean([r["val_acc"] for r in results]))
    mean_auc = np.mean(np.array([r["val_aucs"] for r in results]), axis=0)
    log(f"Final results: Mean Accuracy: {mean_ac}")
    for i, a in enumerate(mean_auc):
        log(f"Class {i}: Mean AUC = {a:.4f}")
    return {"mean_accuracy": mean_ac, "mean_auc": [float(a) for a in mean_auc],
            "iterations": results}


def run_5fold_cv_standalone_test(bags: List[Bag], cfg: WSITrainConfig,
                                 log: Callable[[str], None] = print,
                                 save_dir: Optional[str] = None,
                                 permutation: Optional[Sequence[int]] = None,
                                 ) -> dict:
    """train_tcga.py:350-429: hold out a ``split`` fraction, 5-fold CV on
    the rest, then a majority vote of the 5 fold models (each at its
    optimal thresholds) on the holdout. ``permutation`` replaces the
    holdout/rest shuffle (holdout = its first ``split`` fraction)."""
    from scipy.stats import mode

    trainer = _make_trainer(cfg)
    log = _main_log(log)
    rng = np.random.default_rng(cfg.seed)
    store = _global_store(bags, cfg, trainer)
    if permutation is not None:
        order = np.asarray(permutation, dtype=np.int64)
        if sorted(order.tolist()) != list(range(len(bags))):
            raise ValueError("permutation must be a permutation of range(n_bags)")
    else:
        order = rng.permutation(len(bags))
    n_hold = int(cfg.split * len(bags))
    holdout = [bags[i] for i in order[:n_hold]]
    rest_idx = order[n_hold:]

    fold_models = []
    fold_results = []
    scheme = "5-fold-cv-standalone-test"
    for fold, (tr_idx, te_idx) in enumerate(_kfold_indices(len(rest_idx), 5)):
        resumed = _try_resume_fold(trainer, cfg, save_dir, fold, log, scheme)
        if resumed is None:
            log(f"Starting CV fold {fold}.")
            save_cb = _fold_saver(save_dir, fold, cfg.model) if save_dir else None
            tr, te = _fold_views(store, bags, rest_idx[tr_idx], rest_idx[te_idx])
            best = train_fold(trainer, tr, te, cfg,
                              np.random.default_rng([cfg.seed, fold]),
                              _fold_init(cfg, fold), log, save_cb,
                              state_dir=_fold_state_dir(save_dir, fold),
                              state_fp=_cfg_fingerprint(cfg, scheme))
            _mark_fold_done(save_dir, fold, best, scheme, cfg)
        else:
            best = resumed
        fold_models.append((best["params"], best["thresholds"]))
        fold_results.append(best)

    holdout_eval = holdout
    if store is not None:
        holdout_eval = store.subset(order[:n_hold])
    fold_predictions = []
    labels = None
    eval_rng = np.random.default_rng([cfg.seed, 5])  # resume-independent
    for params, thresholds in fold_models:
        res = evaluate_bags(trainer, _load(trainer, params), holdout_eval, cfg,
                            thresholds=thresholds, rng=eval_rng)
        fold_predictions.append(res["predictions"])
        labels = res["labels"]
    stack = np.stack(fold_predictions, axis=0)
    combined = np.atleast_1d(np.squeeze(mode(stack, axis=0, keepdims=True).mode[0]))
    final = metrics.standalone_test_metrics(labels, combined, cfg.num_classes)
    for k, v in final.items():
        log(f"{k}: {v}")

    out = {
        "final": final,
        "folds": [{"acc": b["acc"], "aucs": b["aucs"],
                   "thresholds": b["thresholds"]} for b in fold_results],
    }
    if save_dir and is_main():
        os.makedirs(os.path.join(save_dir, "test"), exist_ok=True)
        with open(os.path.join(save_dir, "test", "test_list.json"), "w") as f:
            json.dump([b.name for b in holdout], f)
        for i, (params, thresholds) in enumerate(fold_models):
            torch_ckpt.save_mil_pth(
                params, os.path.join(save_dir, "test",
                                     f"mil_weights_fold_{i}.pth"), cfg.model)
            with open(os.path.join(save_dir, "test",
                                   f"mil_threshold_fold_{i}.json"), "w") as f:
                json.dump([float(t) for t in thresholds], f)
    return out


def _fold_marker(save_dir: str, fold: int) -> str:
    return os.path.join(save_dir, f"fold_{fold}.done.json")


def _fold_state_dir(save_dir: Optional[str], fold: int) -> Optional[str]:
    """Where a fold's mid-fold train state lives."""
    return os.path.join(save_dir, f"fold_{fold}_state") if save_dir else None


def _clear_fold_state(save_dir: Optional[str], fold: int) -> None:
    """Remove a completed fold's mid-fold state, with the ``.prev`` and
    ``.inflight`` siblings of a save that crashed mid-swap. Called only
    after the completion marker is on disk."""
    state_dir = _fold_state_dir(save_dir, fold)
    if not state_dir:
        return
    for d in (state_dir, state_dir + ".prev", state_dir + ".inflight"):
        shutil.rmtree(d, ignore_errors=True)


def _try_resume_iteration(cfg: WSITrainConfig, save_dir: Optional[str],
                          it: int, log, scheme: str) -> Optional[dict]:
    """Adopt a completed 5-time-tvt iteration's metrics if its marker
    belongs to this experiment."""
    if not (cfg.resume and save_dir):
        return None
    barrier()  # rank 0 has finished writing the previous iteration
    marker = os.path.join(save_dir, f"iter_{it}.done.json")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        meta = json.load(f)
    if meta.pop("fingerprint", None) != _cfg_fingerprint(cfg, scheme):
        log(f"iteration {it}: existing marker was produced by a different "
            "config; retraining.")
        return None
    log(f"Resuming iteration {it} from its marker "
        f"(test acc {meta['test_acc']:.4f}).")
    return meta


def _mark_iteration_done(save_dir: Optional[str], it: int, res: dict,
                         scheme: str, cfg: WSITrainConfig) -> None:
    if not save_dir or not is_main():
        return
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"iter_{it}.done.json"), "w") as f:
        json.dump({**{k: (list(map(float, v)) if isinstance(v, (list, tuple))
                          else float(v)) for k, v in res.items()},
                   "fingerprint": _cfg_fingerprint(cfg, scheme)}, f)
    _clear_fold_state(save_dir, it)


def _cfg_fingerprint(cfg: WSITrainConfig, scheme: str) -> str:
    """Identifies an experiment, so that --resume never adopts another
    run's results; the JAX package's string, field for field. The scheme is
    part of it: the schemes share the fold_{k}.pth namespace, and a
    standalone-test run adopting plain-CV folds would score its holdout
    with models trained on it."""
    return (f"{scheme}|{cfg.model}|{cfg.seed}|{cfg.lr}|{cfg.num_epochs}|"
            f"{cfg.stop_epochs}|{cfg.weight_decay}|{cfg.num_classes}|"
            f"{cfg.feats_size}|{cfg.nonlinear}|{cfg.dropout_patch}|"
            f"{cfg.dropout_node}|{cfg.split}|{cfg.average}|{cfg.eta_min}|"
            f"{cfg.eval_interval}"
            + (f"|dp{cfg.data_parallel}" if cfg.data_parallel else "")
            # the store and list paths draw the host RNG differently
            + ("" if cfg.use_device_store else "|nostore"))


def _try_resume_fold(trainer: BagTrainer, cfg: WSITrainConfig,
                     save_dir: Optional[str], fold: int, log,
                     scheme: str) -> Optional[dict]:
    """A completed fold's best model and metrics, if its marker exists and
    belongs to this experiment."""
    if not (cfg.resume and save_dir):
        return None
    barrier()  # rank 0 has finished writing the previous fold
    marker = _fold_marker(save_dir, fold)
    pth = os.path.join(save_dir, f"fold_{fold}.pth")
    if not (os.path.exists(marker) and os.path.exists(pth)):
        return None
    with open(marker) as f:
        meta = json.load(f)
    if meta.get("fingerprint") != _cfg_fingerprint(cfg, scheme):
        log(f"fold {fold}: existing marker was produced by a different "
            "config; retraining (weights will be overwritten).")
        return None
    model, _, _ = torch_ckpt.load_mil_pth(pth, trainer.device)
    log(f"Resuming fold {fold} from {pth} (acc {meta['acc']:.4f}).")
    return {"score": metrics.current_score(meta["acc"], meta["aucs"]),
            "params": _snapshot(model), "thresholds": meta["thresholds"],
            "acc": meta["acc"], "aucs": meta["aucs"]}


def _mark_fold_done(save_dir: Optional[str], fold: int, best: dict,
                    scheme: str, cfg: Optional[WSITrainConfig] = None) -> None:
    if not save_dir or not is_main():
        return
    os.makedirs(save_dir, exist_ok=True)
    with open(_fold_marker(save_dir, fold), "w") as f:
        json.dump({"acc": best["acc"], "aucs": list(map(float, best["aucs"])),
                   "thresholds": list(map(float, best["thresholds"])),
                   "fingerprint": _cfg_fingerprint(cfg, scheme) if cfg else None},
                  f)
    _clear_fold_state(save_dir, fold)


def _fold_saver(save_dir: str, fold: int, model: str = "dsmil"):
    """Best-model persistence of the reference's save_model:
    ``fold_{k}.pth`` and its thresholds ``fold_{k}.json``; None off rank
    0, which alone writes."""
    if not is_main():
        return None
    os.makedirs(save_dir, exist_ok=True)

    def save_cb(params, thresholds):
        torch_ckpt.save_mil_pth(params, os.path.join(save_dir,
                                                     f"fold_{fold}.pth"), model)
        with open(os.path.join(save_dir, f"fold_{fold}.json"), "w") as f:
            json.dump([float(t) for t in thresholds], f)

    return save_cb
