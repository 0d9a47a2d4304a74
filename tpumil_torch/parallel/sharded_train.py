"""Data-parallel minibatch training over ``torch.distributed``
(counterpart of tpumil/parallel/sharded_train.py): one Adam step per chunk
of bags on the mean of their dual-stream losses, with parameters and
optimizer state replicated on every rank of a (data, inst) mesh.

Layout. The JAX step leaves the layout to GSPMD for any registry model:
bags over ``data``, instances over ``inst``. Here each chunk's bags are
spread, whole, over all data x inst ranks in contiguous blocks, the chunk
padded to a multiple of the rank count with gated dummy bags (the layout
``make_batch_sharded_jit`` gives images in the JAX package): every rank
runs the registry model's own forward on whole bags, and no model needs a
hand-sharded forward. Giant bags go through ``inst_shard``
(parallel/bag_shard.py). The result is the JAX step's, which is
mesh-invariant (tests/test_parallel.py); only the layout differs.

Gradients. Each rank sums its real bags' losses and back-propagates the
sum; one all-reduce sums the gradients, the loss sum and the real-bag
count, and every rank divides by that count before its Adam step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.registry import get_model
from tpumil_torch.ops.losses import dual_stream_loss
from tpumil_torch.parallel.bag_shard import collective
from tpumil_torch.parallel.mesh import DATA_AXIS, INST_AXIS, axis_size
from tpumil_torch.train.optim import adam_torch, set_lr
from tpumil_torch.train.trainer import BagTrainer


def make_sharded_train_step(cfg: DSMILConfig, mesh, optimizer=None,
                            model: str = "dsmil"):
    """Returns ``(step, optimizer)``: ``optimizer(params)`` makes the
    optimizer (default Adam(0.5, 0.9), weight decay 1e-3), and
    ``step(net, opt, feats, labels, lr=None, real=None, pos_weight=None)
    -> (net, opt, mean_loss)`` performs one minibatch Adam update over the
    chunk ``feats`` (a sequence of B whole bags [N_b, K], the same on every
    rank), ``labels`` [B, C]. ``real`` [B] bool gates count-padding dummy
    bags out of the objective (None: every bag is real); ``pos_weight``
    [C] weights positive targets like BCEWithLogitsLoss(pos_weight).
    Dropout (passing_v) has no place on this path. The forwards run in
    ``cfg.compute_dtype``; the losses, the gradients and Adam in f32."""
    if cfg.passing_v and cfg.dropout_v > 0.0:
        raise NotImplementedError(
            "the sharded minibatch step has no dropout rng plumbing; "
            "train passing_v+dropout_v models through BagTrainer")
    mil = get_model(model)
    optimizer = optimizer or functools.partial(adam_torch, weight_decay=1e-3)
    if axis_size(mesh, DATA_AXIS) * axis_size(mesh, INST_AXIS) \
            != dist.get_world_size():
        raise ValueError("the data-parallel step needs a mesh over the "
                         "whole process group")

    def step(net, opt, feats: Sequence[torch.Tensor], labels: torch.Tensor,
             lr=None, real=None, pos_weight=None):
        if lr is not None:
            set_lr(opt, lr)
        world, r = dist.get_world_size(), dist.get_rank()
        b = len(feats)
        per = -(-b // world)  # contiguous block of the padded chunk
        real = np.ones(b, bool) if real is None else np.asarray(real, bool)
        params = list(net.parameters())
        opt.zero_grad(set_to_none=True)
        local = torch.zeros((), device=labels.device)
        mine = [i for i in range(r * per, min((r + 1) * per, b)) if real[i]]
        for i in mine:
            c, bag_logits, _, _ = net(feats[i],
                                      compute_dtype=cfg.compute_dtype)
            local = local + dual_stream_loss(
                bag_logits, mil.max_instance_logits(c, None), labels[i],
                pos_weight)
        if local.requires_grad:
            local.backward()
        # gradients, which parameters got one anywhere, the loss sum and
        # the real-bag count, in one all-reduce
        has = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.float32, device=labels.device)
        flat = [p.grad.reshape(-1) if p.grad is not None
                else torch.zeros(p.numel(), device=p.device) for p in params]
        flat += [has, local.detach().reshape(1),
                 torch.tensor([float(len(mine))], device=labels.device)]
        buf = collective("sum", torch.cat(flat), None)
        n_real = buf[-1].clamp_min(1.0)
        j = 0
        for p, got_any in zip(params, buf[-2 - len(params):-2].tolist()):
            # a parameter no rank's bags reached keeps no gradient, so Adam
            # skips it as the single-device step does
            p.grad = (buf[j:j + p.numel()] / n_real).view_as(p) \
                if got_any else None
            j += p.numel()
        opt.step()
        return net, opt, buf[-2] / n_real

    return step, optimizer


def check_data_parallel(dp: int, sp: int, dropout_patch: float) -> None:
    """The data-parallel trainer's refusals that need no process group."""
    if dropout_patch > 0.0:
        raise NotImplementedError(
            "the sharded minibatch step has no dropout rng plumbing; train "
            "dropout_patch>0 models on the single-device BagTrainer")
    if sp & (sp - 1) or dp & (dp - 1):
        raise ValueError(f"mesh axes must be powers of two (got "
                         f"data={dp}, inst={sp})")


@dataclasses.dataclass
class DataParallelBagTrainer(BagTrainer):
    """BagTrainer whose buckets train as minibatch Adam steps of up to
    ``chunk_size`` bags each, spread over a (data, inst) mesh.

    A DOCUMENTED DEVIATION from the reference's optimization: the reference
    (and BagTrainer, InstanceShardedBagTrainer) takes one Adam step per bag
    (train_tcga.py:55-76); this mode averages the dual-stream loss over up
    to ``chunk_size`` bags and steps once -- fewer, smoother steps, for
    throughput. ``WSITrainConfig.data_parallel`` selects it, and the
    experiment fingerprint includes it, so --resume never mixes the two.

    Everything else is inherited: the epoch shuffle and host RNG draws,
    bucketing, eval, pos_weight."""

    mesh: object = None

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError(
                "DataParallelBagTrainer requires a (data, inst) mesh "
                "(tpumil_torch.parallel.mesh.make_mesh)")
        dp, sp = axis_size(self.mesh, DATA_AXIS), axis_size(self.mesh,
                                                            INST_AXIS)
        check_data_parallel(dp, sp, self.dropout_patch)
        super().__post_init__()
        self.fused_threshold = None
        self._fused_eligible = False
        self.min_bucket = max(self.min_bucket, sp)
        self._dp_step, _ = make_sharded_train_step(self.cfg, self.mesh,
                                                   model=self.model)

    def _train_bags(self, model, opt, items, fused, generator):
        """Minibatch steps of up to ``chunk_size`` bags each, in ``items``
        order. Returns the SUM of the per-bag losses (each chunk's mean
        times its bag count), the callers' per-bag averaging contract. A
        store hands over a whole bucket, so the chunking matters: one step
        per bucket would be about one step per epoch."""
        model.train()
        pw = self._pw()
        total = torch.zeros((), device=self.device)
        for start in range(0, len(items), self.chunk_size):
            chunk = items[start:start + self.chunk_size]
            labels = torch.stack([label for _, label in chunk])
            model, opt, loss = self._dp_step(
                model, opt, [f for f, _ in chunk], labels, pos_weight=pw)
            total = total + loss * len(chunk)
        model.eval()
        return total
