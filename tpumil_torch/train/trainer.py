"""Per-bag trainer of the MIL aggregators (counterpart of
tpumil/train/trainer.py): any registry model (models/registry.py), with
the model's objective and recipe: the dual-stream objective on its bag
logits and its max instance logit, sigmoid scores and Adam (DSMIL, ABMIL,
pooling), or the softmax cross-entropy on its bag logits, softmax scores
and Lookahead(RAdam) (TransMIL).

One Adam step per bag, in the order the host RNG draws: the reference's
optimization (train_tcga.py:55-76). Bags run unpadded and eagerly, one
forward/backward per bag; the JAX package's padding to bucket lengths and
its ``lax.scan`` over chunks exist for XLA's static shapes and are not
needed here. What is kept is the visitation order: the list path groups the
shuffled order into bucketed chunks, the store path walks buckets in a
shuffled order, and every host RNG draw of the JAX trainer is made here too
(permutations, and one ``rng.integers(1 << 62)`` per chunk or bucket, which
seeds the ``torch.Generator`` of patch and value dropout). With dropout off
the two trainers take the same steps in the same order from the same
parameters.

Giant DSMIL bags route to the streaming kernels K1-K3
(ops/attention_pool.py, at any feature width), which keep no [N, D]
activation. ``fused_threshold`` decides per bucket, as
``_use_fused`` does in the JAX package. K3 writes the feature gradient only
when feats need one, and bag features are constants here, so the kernel
step holds K3's dz1 scratch (4 D bytes per instance) and K1's logits (4 C
bytes per instance): 533 B per instance measured on an H100 at K = 512,
C = 2, against 2576 B for the eager step (PERF.md section 5).

``cfg.compute_dtype`` sets the dtype of every model forward (train and
eval); parameters, gradients and Adam's moments stay f32, and the losses
are taken in f32. The kernels compute in f32, so only an f32 config is
routed to them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpumil_torch.data.bags import Bag, bucketed_chunks
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.models.dsmil import DSMILConfig, sigmoid
from tpumil_torch.models.registry import get_model
from tpumil_torch.ops.attention_pool import fused_bag_forward, fused_bag_loss
from tpumil_torch.ops.losses import (class_scores, cross_entropy_loss,
                                     dual_stream_loss)
from tpumil_torch.train.optim import adam_torch, lookahead_radam, set_lr
from tpumil_torch.utils.device import select_device
from tpumil_torch.utils.prof import span

# -- giant-bag memory model ---------------------------------------------------
# Memory the "auto" route may plan for on the CPU: the JAX package's 13 GiB
# constant, kept so that its routing decisions carry over to tests here.
HOST_BUDGET_BYTES = 13 * 2 ** 30
# Peak transient bytes per bag instance of one eager unfused step (forward,
# backward and Adam) and of one eager eval forward, at feats_size 512,
# scaled linearly in K: the slope of torch.cuda.max_memory_allocated over
# the bag size on an H100 (2576 and 1032 B, PERF.md section 5), rounded up.
# Measured with f32 features and compute; a bf16 store or compute keeps
# them, which over-bounds, in the safe direction.
STEP_BYTES_PER_INSTANCE = 3 * 1024
EVAL_BYTES_PER_INSTANCE = 3 * 512
# Share of the card's reachable memory the estimate may fill; the rest is
# left to the caching allocator's fragmentation.
CUDA_BUDGET_FRACTION = 0.9


def memory_budget_bytes(device: torch.device) -> int:
    """Bytes the "auto" route may plan for: on a CUDA device, a share of
    what this process can reach (free memory plus the allocator's
    reserve); elsewhere :data:`HOST_BUDGET_BYTES`."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(CUDA_BUDGET_FRACTION
                   * (free + torch.cuda.memory_reserved(device)))
    return HOST_BUDGET_BYTES


def step_workingset_bytes(nmax: int, feats_size: int = 512) -> int:
    """Estimated peak transient bytes of one eager train step on a bag of
    ``nmax`` instances."""
    return int(STEP_BYTES_PER_INSTANCE * (feats_size / 512.0) * nmax)


def eval_workingset_bytes(nmax: int, feats_size: int = 512) -> int:
    """Estimated peak transient bytes of one eager eval forward."""
    return int(EVAL_BYTES_PER_INSTANCE * (feats_size / 512.0) * nmax)


def patch_dropout_mask(generator: Optional[torch.Generator], n: int,
                       keep_frac: float, device: torch.device) -> torch.Tensor:
    """Keep ``int(n * keep_frac)`` of a bag's ``n`` instances, chosen
    uniformly at random (the reference's random row subset,
    train_tcga.py:78-83). The count is taken in float64, as the reference
    computes it."""
    k = int(n * float(keep_frac))
    u = torch.rand(n, generator=generator, device=device)
    keep = torch.zeros(n, dtype=torch.bool, device=device)
    keep[torch.argsort(u)[:k]] = True
    return keep


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


@dataclasses.dataclass
class BagTrainer:
    """Per-bag trainer of registry model ``model``.

    Usage:
        trainer = BagTrainer(cfg, device=torch.device("cuda"))
        model, optimizer = trainer.init(torch.Generator().manual_seed(0))
        for epoch in range(E):
            model, optimizer, loss = trainer.train_epoch(
                model, optimizer, bags, lr=schedule(epoch), rng=np_rng)
            scores, losses = trainer.predict(model, bags)
    """

    cfg: DSMILConfig
    weight_decay: float = 0.0
    pos_weight: Optional[np.ndarray] = None
    dropout_patch: float = 0.0
    chunk_size: int = 64
    min_bucket: int = 16
    eval_batch: int = 64
    model: str = "dsmil"
    # Route of a bucket to the streaming kernels K1-K3: "auto" when the
    # eager step's estimated peak (residents + working set) would not fit
    # memory_budget_bytes(); an int N for buckets of length >= N; None for
    # never. Only the reference configuration is eligible (dsmil, nonlinear
    # q, passing_v=False, no patch dropout, f32 compute).
    fused_threshold: object = "auto"
    # other device residents the caller keeps alive (a global store whose
    # fold subsets are trained), added to the "auto" estimate
    extra_resident_bytes: int = 0
    # None: the card (select_device("cuda"), which raises without one)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self._mil = get_model(self.model)  # unknown names raise here
        self._ce = self._mil.objective == "cross_entropy"
        if self._ce and self.cfg.compute_dtype != torch.float32:
            raise ValueError(f"model {self.model!r} computes in float32, "
                             f"not {self.cfg.compute_dtype}")
        if self.device is None:
            self.device = select_device("cuda")
        self._fused_eligible = (
            self.model == "dsmil" and self.cfg.nonlinear
            and not self.cfg.passing_v and self.dropout_patch == 0.0
            and self.cfg.compute_dtype == torch.float32
            and self.fused_threshold is not None)
        self.fused_dispatches = 0  # buckets or chunks run through K1-K3

    # -- routing -------------------------------------------------------------

    def _use_fused(self, nmax: int, bucket_bytes: int = 0) -> bool:
        """Train route of a bucket of length ``nmax``; ``bucket_bytes`` are
        the device-resident data bytes beside it."""
        if not self._fused_eligible:
            return False
        if self.fused_threshold == "auto":
            est = (self.extra_resident_bytes + bucket_bytes
                   + step_workingset_bytes(nmax, self.cfg.feats_size))
            return est > memory_budget_bytes(self.device)
        return nmax >= self.fused_threshold

    def _use_fused_eval(self, nmax: int, resident_bytes: int = 0) -> bool:
        """Eval route: each bag is evaluated alone and unpadded, so under
        "auto" only a single bag's forward has to fit."""
        if self.fused_threshold == "auto":
            est = (self.extra_resident_bytes + resident_bytes
                   + eval_workingset_bytes(nmax, self.cfg.feats_size))
            return self._fused_eligible and est > memory_budget_bytes(
                self.device)
        return self._use_fused(nmax, resident_bytes)

    def _route(self, fused: bool) -> bool:
        self.fused_dispatches += int(fused)
        return fused

    def _train_route(self, nmax: int, bucket_bytes: int) -> bool:
        with span("train.route"):  # "auto" asks the card for its memory
            return self._route(self._use_fused(nmax, bucket_bytes))

    # -- steps ---------------------------------------------------------------

    def _pw(self) -> Optional[torch.Tensor]:
        if self.pos_weight is None:
            return None
        return _as_tensor(self.pos_weight, self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, generator: torch.Generator
             ) -> Tuple[torch.nn.Module, torch.optim.Adam]:
        model = self._mil.init_params(generator, self.cfg, self.device)
        return model, self.make_optimizer(model)

    def make_optimizer(self, model: torch.nn.Module):
        """The optimizer of the model's recipe (``weight_decay`` is Adam's
        L2 term, or RAdam's decoupled decay)."""
        if self._mil.recipe == "lookahead_radam":
            return lookahead_radam(model.parameters(),
                                   weight_decay=self.weight_decay)
        return adam_torch(model.parameters(), weight_decay=self.weight_decay)

    def _train_bags(self, model: torch.nn.Module, opt: torch.optim.Optimizer,
                    items: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                    fused: bool, generator: torch.Generator) -> torch.Tensor:
        """One Adam step per (feats, label); returns the sum of the losses
        as a device scalar (no host sync)."""
        model.train()
        pw = self._pw()
        total = torch.zeros((), device=self.device)
        for feats, label in items:
            with span("train.step"):
                opt.zero_grad(set_to_none=True)
                with span("train.forward"):
                    loss = self._bag_loss(model, feats, label, pw, fused,
                                          generator)
                with span("train.backward"):
                    loss.backward()
                with span("train.optim"):
                    opt.step()
            total = total + loss.detach()
        model.eval()
        return total

    def _bag_loss(self, model, feats, label, pw, fused: bool,
                  generator: torch.Generator) -> torch.Tensor:
        if fused:
            return fused_bag_loss(model, feats, label, pw)
        mask = None
        if self.dropout_patch > 0.0:
            mask = patch_dropout_mask(generator, feats.shape[0],
                                      1.0 - self.dropout_patch, self.device)
        c, bag_logits, _, _ = model(feats, mask, dropout_generator=generator,
                                    compute_dtype=self.cfg.compute_dtype)
        if self._ce:
            return cross_entropy_loss(bag_logits, label, pw)
        return dual_stream_loss(
            bag_logits, self._mil.max_instance_logits(c, mask), label, pw)

    def _eval_bags(self, model: torch.nn.Module,
                   items: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   fused: bool, generator: torch.Generator
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(losses [b], scores [b, C], avg_scores [b, C]) on the host."""
        model.eval()
        pw = self._pw()
        out = []
        with torch.no_grad():
            for feats, label in items:
                if fused:
                    bag_logits, max_logits = fused_bag_forward(model, feats)
                else:
                    mask = None
                    if self.dropout_patch > 0.0:  # as the reference, in eval too
                        mask = patch_dropout_mask(
                            generator, feats.shape[0],
                            1.0 - self.dropout_patch, self.device)
                    c, bag_logits, _, _ = model(
                        feats, mask, compute_dtype=self.cfg.compute_dtype)
                    if not self._ce:
                        max_logits = self._mil.max_instance_logits(c, mask)
                if self._ce:
                    loss = cross_entropy_loss(bag_logits, label, pw)
                    scores = avg = class_scores(bag_logits)
                else:
                    loss = dual_stream_loss(bag_logits, max_logits, label, pw)
                    # in the compute dtype, as the JAX package's eval; f32
                    # only where they are stacked
                    scores = sigmoid(bag_logits)
                    avg = scores + sigmoid(max_logits)
                out.append(torch.cat([loss[None], scores.float(),
                                      avg.float()]))
        res = torch.stack(out).cpu().numpy()
        c = self.cfg.num_classes
        return res[:, 0], res[:, 1:1 + c], res[:, 1 + c:]

    # -- public API ------------------------------------------------------------

    def train_epoch(self, model: torch.nn.Module,
                    opt: torch.optim.Optimizer, bags, lr: float,
                    rng: np.random.Generator, *, shuffle: bool = True
                    ) -> Tuple[torch.nn.Module, object, float]:
        """One epoch of per-bag steps; ``bags`` is a Sequence[Bag] (features
        moved per chunk) or a DeviceBagStore. Returns (model, optimizer,
        mean loss)."""
        with span("train.epoch"):
            if isinstance(bags, DeviceBagStore):
                losses = self._store_epoch(model, opt, bags, lr, rng, shuffle)
                return model, opt, _mean(losses, bags.num_bags)
            set_lr(opt, lr)
            order = rng.permutation(len(bags)) if shuffle \
                else np.arange(len(bags))
            losses = []
            for idxs, nmax in bucketed_chunks(bags, order, self.chunk_size,
                                              self.min_bucket):
                with span("train.bucket"):
                    generator = self._generator(int(rng.integers(1 << 62)))
                    items = self._host_items(bags, idxs)
                    fused = self._train_route(nmax, _nbytes(items))
                    losses.append(self._train_bags(model, opt, items, fused,
                                                   generator))
            return model, opt, _mean(losses, len(bags))

    def _host_items(self, bags: Sequence[Bag], idxs):
        return [(_as_tensor(bags[i].feats, self.device),
                 _as_tensor(np.atleast_1d(bags[i].label), self.device))
                for i in idxs]

    @staticmethod
    def _store_items(store: DeviceBagStore, rows):
        return [(store.bag(i), store.label(i)) for i in rows]

    def _store_epoch(self, model, opt, store: DeviceBagStore, lr: float,
                     rng: np.random.Generator, shuffle: bool = True
                     ) -> List[torch.Tensor]:
        """One epoch over a store: buckets in a shuffled order, bags of a
        bucket in a fresh permutation. Per-bucket loss sums stay on the
        device."""
        set_lr(opt, lr)
        sizes = list(store.bucket_sizes)
        if shuffle:
            rng.shuffle(sizes)
        losses = []
        for nmax in sizes:
            with span("train.bucket"):
                n_real = store.counts[nmax]
                perm = rng.permutation(n_real) if shuffle \
                    else np.arange(n_real)
                generator = self._generator(int(rng.integers(1 << 62)))
                fused = self._train_route(nmax, store.nbytes())
                rows = store.index[nmax][perm]
                losses.append(self._train_bags(
                    model, opt, self._store_items(store, rows), fused,
                    generator))
        return losses

    def train_epochs(self, model: torch.nn.Module, opt: torch.optim.Optimizer,
                     store: DeviceBagStore, lrs: Sequence[float],
                     rng: np.random.Generator):
        """``len(lrs)`` epochs over a store; returns (model, optimizer,
        mean loss per epoch [E]). The host RNG is drawn as the JAX package
        draws it: for a single-bucket store, all E permutations first and
        then ONE integer for every epoch's dropout stream; otherwise epoch
        by epoch, as ``train_epoch``."""
        e = len(lrs)
        with span("train.epoch"):
            if len(store.bucket_sizes) == 1:
                nmax = store.bucket_sizes[0]
                perms = [rng.permutation(store.counts[nmax])
                         for _ in range(e)]
                generator = self._generator(int(rng.integers(1 << 62)))
                fused = self._train_route(nmax, store.nbytes())
                losses = []
                for perm, lr in zip(perms, lrs):
                    with span("train.bucket"):
                        set_lr(opt, lr)
                        rows = store.index[nmax][perm]
                        losses.append(self._train_bags(
                            model, opt, self._store_items(store, rows), fused,
                            generator))
                per_epoch = [[x] for x in losses]
            else:
                per_epoch = [self._store_epoch(model, opt, store, lr, rng)
                             for lr in lrs]
            return model, opt, np.asarray([_mean(ls, store.num_bags)
                                           for ls in per_epoch], np.float64)

    def predict(self, model: torch.nn.Module, bags, *, average: bool = False,
                rng: Optional[np.random.Generator] = None,
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Scores [num_bags, C] and losses [num_bags], in bag order. With
        ``average`` the scores are ``sigmoid(bag) + sigmoid(max instance)``,
        the reference's ``--average`` (refused for a model with no instance
        stream). One ``rng.integers`` per chunk or bucket, as the JAX
        trainer draws."""
        if average and self._ce:
            raise ValueError(f"--average adds the max instance score; model "
                             f"{self.model!r} has no instance stream")
        rng = rng or np.random.default_rng(0)
        if isinstance(bags, DeviceBagStore):
            n = bags.num_bags
            groups = [(bags.index[nmax], nmax, bags.nbytes(),
                       lambda idx: self._store_items(bags, idx))
                      for nmax in bags.bucket_sizes]
        else:
            n = len(bags)
            groups = []
            for idxs, nmax in bucketed_chunks(bags, range(n), self.eval_batch,
                                              self.min_bucket):
                groups.append((np.asarray(idxs), nmax, None,
                               lambda idx: self._host_items(bags, idx)))
        scores_out = np.zeros((n, self.cfg.num_classes), np.float32)
        losses_out = np.zeros((n,), np.float32)
        for idx, nmax, resident, items_of in groups:
            generator = self._generator(int(rng.integers(1 << 62)))
            items = items_of(idx)
            fused = self._route(self._use_fused_eval(
                nmax, _nbytes(items) if resident is None else resident))
            losses, scores, avg_scores = self._eval_bags(model, items, fused,
                                                         generator)
            scores_out[idx] = avg_scores if average else scores
            losses_out[idx] = losses
        return scores_out, losses_out


def _nbytes(items) -> int:
    return sum(int(f.nbytes) for f, _ in items)


def _mean(losses: List[torch.Tensor], n: int) -> float:
    """Sum of per-bucket device loss sums over ``n`` bags (one host sync)."""
    if not losses:
        return 0.0
    with span("train.sync"):
        return float(torch.stack(losses).double().sum()) / max(n, 1)
