"""Instance-sharded (sequence-parallel) DSMIL over ``torch.distributed``
(counterpart of tpumil/parallel/bag_shard.py): the reference-faithful
per-bag path for bags larger than one device.

A bag's rows are split over the ranks of the mesh's ``inst`` group, each
rank holding a contiguous block, and the three cross-instance reductions
become collectives:

  1. critical-instance selection: a local masked max per class, then one
     all-gather of every rank's (best value, best feature row) and the first
     maximum across ranks -- O(P C K) bytes;
  2. the softmax over N: an all-reduce MAX of the detached local maxima
     (gradient-neutral);
  3. the softmax's denominator and the bag embedding A^T V: one all-reduce
     SUM of the local [C] sums of exponentials and [C, K] partials.

Three collectives forward, two backward and the gradient average: six a
step, each a host round of the process group, so what can travel together
does.

The q-MLP of the critical rows and the bag head are replicated.

Gradients. Every rank computes the same loss. The collectives are
``torch.autograd.Function``s whose backward sums the cotangents of every
rank's copy (all-reduce SUM -> all-reduce SUM; all-gather -> the sum over
ranks of each rank's slice, a reduce-scatter), so each rank's gradient is
that of P copies of the loss through its own rows and replicas; the
parameter gradients are then averaged over the ``inst`` group, which gives
the single-device gradient exactly: a local path gets P times its true
cotangent, divided by P, and a replicated path once on each of P ranks,
summed and divided by P. Adam then runs on every rank on the same reduced
gradients, and the parameters stay bitwise equal across ranks.

The fused kernels K1-K3 are single-device and are not used here, as in the
JAX package (``fused_threshold = None``): sharding is this path's memory
escape hatch. The forward runs in ``compute_dtype`` (the trainer passes
``cfg.compute_dtype``) and casts where the JAX package's does; its
collectives then move bf16, which gloo and NCCL both take.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpumil_torch.data.bags import Bag, bucket_length
from tpumil_torch.models.dsmil import ATTN_DIM, in_dtype
from tpumil_torch.ops.losses import dual_stream_loss
from tpumil_torch.ops.masked import NEG_INF, _fill, masked_argmax, masked_max
from tpumil_torch.parallel.mesh import INST_AXIS, axis_size
from tpumil_torch.train.optim import adam_torch, set_lr
from tpumil_torch.train.trainer import BagTrainer
from tpumil_torch.utils.device import disable_tf32


def collective(op: str, x: torch.Tensor, group) -> torch.Tensor:
    """Every collective of this module, counted: ``all_gather`` returns
    ``[P, *x.shape]``, ``sum`` and ``max`` all-reduce ``x`` in place."""
    collective.calls += 1
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return x


# collective calls since the last reset, forward, backward and the gradient
# average together (a plain int, like the kernels' launch counters)
collective.calls = 0


class AllGather(torch.autograd.Function):
    """``[P, *x.shape]``: every rank's ``x``. Backward: this rank's slice of
    the sum over ranks of the cotangents (a reduce-scatter; written as an
    all-reduce of the small [P, ...] cotangent, which gloo and NCCL both
    run)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective("all_gather", x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = collective("sum", grad.contiguous().clone(), ctx.group)
        return grad[dist.get_rank(ctx.group)], None


class AllReduceSum(torch.autograd.Function):
    """The sum over ranks. Backward: the sum over ranks of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective("sum", x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return collective("sum", grad.contiguous().clone(), ctx.group), None


def _local_forward(model, feats: torch.Tensor, mask: Optional[torch.Tensor],
                   group, compute_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runs on each rank on its block feats [n_local, K], mask [n_local]
    (None: every row real). Returns the replicated (bag_logits [C],
    max_instance_logits [C], bag_embedding [C, K]) in ``compute_dtype``."""
    disable_tf32()
    dt = compute_dtype
    f = feats.to(dt)
    m = None if mask is None else mask[:, None]
    c = model.instance_logits(f, dt)                            # [n, C]

    # critical instance: local masked max and first argmax per class, then
    # the first maximum across ranks of the gathered (value, row) pairs
    best = torch.cat([masked_max(c, m, dim=0)[:, None],
                      f[masked_argmax(c, m, dim=0)]], dim=1)    # [C, 1 + K]
    cand = AllGather.apply(best, group)                         # [P, C, 1 + K]
    all_vals = cand[..., 0]                                     # [P, C]
    winner = all_vals.detach().argmax(dim=0)                    # [C]
    m_feats = cand[winner, torch.arange(winner.shape[0],
                                        device=f.device), 1:]   # [C, K]

    q_max = model.queries(m_feats, dt)                          # [C, D]
    q = model.queries(f, dt)                                    # [n, D]
    a = (q @ q_max.T) * in_dtype(1.0 / math.sqrt(ATTN_DIM), dt)  # [n, C]
    a = _fill(a, m, NEG_INF)

    # softmax over the global N: the max shift is gradient-neutral, so it
    # is taken on detached values
    global_max = collective("max", a.detach().amax(dim=0), group)
    p = _fill(torch.exp(a - global_max[None, :]), m, 0.0)
    v = model._values(f, None, dt)                              # [n, K]
    sums = AllReduceSum.apply(torch.cat([p.sum(dim=0)[:, None], p.T @ v],
                                        dim=1), group)          # [C, 1 + K]
    bemb = sums[:, 1:] / sums[:, :1].clamp_min(
        torch.finfo(p.dtype).tiny)                              # [C, K]
    bag_logits = model.bag_head(bemb, dt)
    # the max instance logit from the gathered candidates: the loss
    # gradient reaches the winning rank's row through AllGather
    return bag_logits, all_vals.amax(dim=0), bemb


def make_instance_sharded_forward(mesh, axis: str = INST_AXIS,
                                  compute_dtype: torch.dtype = torch.float32
                                  ) -> Callable:
    """``fn(model, feats, mask) -> (bag_logits [C], max_instance_logits
    [C], bag_embedding [C, K])`` in ``compute_dtype``, where
    ``feats``/``mask`` are this rank's block of the bag
    (:func:`shard_bag`)."""
    group = mesh.get_group(axis)
    return lambda model, feats, mask=None: _local_forward(
        model, feats, mask, group, compute_dtype)


def shard_bag(mesh, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
              axis: str = INST_AXIS, nmax: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's contiguous block of one bag: rows ``[r b, (r + 1) b)``
    of the bag padded to ``nmax`` rows (default ``feats.shape[0]``), with
    ``b = nmax / P`` -- the rows JAX's ``shard_bag`` places on the r-th
    device of the axis. Padding past the bag's end is not materialised: a
    block holds its real rows only, and a block wholly past the end is one
    masked zero row. ``mask`` None means every row is real."""
    p = axis_size(mesh, axis)
    r = dist.get_rank(mesh.get_group(axis))
    n = feats.shape[0]
    nmax = n if nmax is None else nmax
    if nmax % p or nmax < n:
        raise ValueError(f"a bag of {n} rows padded to {nmax} does not "
                         f"divide across the {axis} axis ({p})")
    b = nmax // p
    lo, hi = min(r * b, n), min((r + 1) * b, n)
    if lo == hi:
        return (feats.new_zeros((1,) + tuple(feats.shape[1:])),
                torch.zeros(1, dtype=torch.bool, device=feats.device))
    return feats[lo:hi], None if mask is None else mask[lo:hi]


def average_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one all-reduce and
    divide them by its size; a missing gradient counts as zeros."""
    buf = collective("sum", torch.cat([
        p.grad.reshape(-1) if p.grad is not None
        else torch.zeros(p.numel(), device=p.device) for p in params]), group)
    size = dist.get_world_size(group)
    i = 0
    for p in params:
        p.grad = (buf[i:i + p.numel()] / size).view_as(p)
        i += p.numel()


def make_instance_sharded_train_step(mesh, optimizer=None,
                                     axis: str = INST_AXIS,
                                     compute_dtype: torch.dtype = torch.float32,
                                     weight_decay: float = 1e-3):
    """The reference's per-bag Adam step (train_tcga.py:55-76) on a bag
    whose rows are split over ``mesh[axis]``.

    Returns ``(step, optimizer)``: ``optimizer(params)`` makes the
    optimizer (default Adam(0.5, 0.9) with ``weight_decay``, the reference
    WSI configuration), and ``step(model, opt, feats, mask, label, lr=None,
    pw=None) -> (model, opt, loss)`` takes this rank's block
    (:func:`shard_bag`); ``lr`` None keeps the optimizer's. The forward runs
    in ``compute_dtype``; the loss, the gradients and Adam in f32."""
    optimizer = optimizer or functools.partial(adam_torch,
                                               weight_decay=weight_decay)
    group = mesh.get_group(axis)

    def step(model, opt, feats, mask, label, lr=None, pw=None):
        if lr is not None:
            set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        bag_logits, max_ins, _ = _local_forward(model, feats, mask, group,
                                                compute_dtype)
        loss = dual_stream_loss(bag_logits, max_ins, label, pw)
        loss.backward()
        average_gradients(list(model.parameters()), group)
        opt.step()
        return model, opt, loss.detach()

    return step, optimizer


def train_bags_sharded(step, mesh, model, opt, bags: Sequence[Bag], lr: float,
                       rng: np.random.Generator, axis: str = INST_AXIS,
                       min_bucket: int = 16, pos_weight=None):
    """One epoch of per-bag steps over ``bags`` in a fresh permutation from
    ``rng``, each bag's rows split over ``mesh[axis]`` as JAX's
    ``shard_bag`` splits the bag padded to ``bucket_length(n, max(
    min_bucket, P))``. ``step`` comes from
    :func:`make_instance_sharded_train_step` over ``mesh``. Returns
    ``(model, opt, losses [n_bags])`` in step order."""
    p = axis_size(mesh, axis)
    min_bucket = max(min_bucket, p)
    device = next(model.parameters()).device
    pw = None if pos_weight is None else torch.as_tensor(
        np.asarray(pos_weight, np.float32), device=device)
    set_lr(opt, lr)
    losses = []
    for i in rng.permutation(len(bags)):
        bag = bags[i]
        feats = torch.from_numpy(np.ascontiguousarray(bag.feats, np.float32))
        f, m = shard_bag(mesh, feats, None, axis,
                         bucket_length(bag.num_instances, min_bucket))
        label = torch.from_numpy(np.atleast_1d(bag.label).astype(np.float32))
        model, opt, loss = step(model, opt, f.to(device),
                                None if m is None else m.to(device),
                                label.to(device), pw=pw)
        losses.append(loss)
    return model, opt, np.asarray([float(x) for x in losses])


def check_inst_shard(n: int, cfg, model: str, dropout_patch: float) -> None:
    """The refusals of the inst-sharded trainer that need no process group,
    so that a CLI raises them before it starts any worker."""
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"inst axis size {n} must be a power of two so every "
            f"power-of-two bag bucket divides evenly across it")
    if dropout_patch > 0.0:
        raise NotImplementedError(
            "the inst-sharded step has no dropout rng plumbing; train "
            "dropout_patch>0 models on the single-device BagTrainer")
    if cfg.passing_v:
        raise NotImplementedError(
            "passing_v is not supported by the inst-sharded forward")
    if model != "dsmil":
        raise NotImplementedError(
            f"only model='dsmil' has an inst-sharded forward "
            f"(got {model!r})")


@dataclasses.dataclass
class InstanceShardedBagTrainer(BagTrainer):
    """:class:`~tpumil_torch.train.trainer.BagTrainer` whose per-bag Adam
    steps run with the bag's rows split over ``mesh[inst_axis]``: the
    multi-device path for bags larger than one device.

    Only the per-bucket executor (``_train_bags``) is overridden: init, the
    epoch shuffle, bucket visitation, every host RNG draw (``train_epochs``
    draws as the JAX package's ``sequential_epochs`` does), eval (every
    rank evaluates whole bags) and pos_weight are inherited, so the
    trajectory is the single-device one to float tolerance."""

    mesh: object = None
    inst_axis: str = INST_AXIS

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("InstanceShardedBagTrainer requires a mesh "
                             "(tpumil_torch.parallel.mesh.make_mesh)")
        n = axis_size(self.mesh, self.inst_axis)
        check_inst_shard(n, self.cfg, self.model, self.dropout_patch)
        super().__post_init__()
        # the fused kernels are single-device: sharding is this path's
        # memory escape hatch
        self.fused_threshold = None
        self._fused_eligible = False
        # every power-of-two bucket divides across the axis
        self.min_bucket = max(self.min_bucket, n)
        # without cfg.compute_dtype a bf16 config would train f32 here
        self._inst_step, _ = make_instance_sharded_train_step(
            self.mesh, axis=self.inst_axis,
            compute_dtype=self.cfg.compute_dtype)

    def _train_bags(self, model, opt, items, fused, generator):
        """One inst-sharded Adam step per (feats, label), in order; the
        sum of the losses as a device scalar. No dropout on this path, so
        ``generator`` is unused (drawn by the caller all the same)."""
        model.train()
        pw = self._pw()
        total = torch.zeros((), device=self.device)
        for feats, label in items:
            f, m = shard_bag(self.mesh, feats, None, self.inst_axis,
                             bucket_length(feats.shape[0], self.min_bucket))
            model, opt, loss = self._inst_step(model, opt, f, m, label,
                                               pw=pw)
            total = total + loss
        model.eval()
        return total
