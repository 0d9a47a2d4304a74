"""SimCLR pretraining of the patch embedder (counterpart of
tpumil/train/simclr_trainer.py).

  * Both augmented views are made on the device (``ops/augment``) from one
    host decode: patches cross to the device as uint8 and become
    ``x.float() / 255`` there (bitwise the JAX package's host f32 divide).
  * One step: augment the two views, backbone and projection (bf16 by
    default; the backbone's weights require grad, so it takes the
    differentiable conv route and never K4 or K5), normalize, NT-Xent,
    backward, one Adam step.
  * ``grad_cache_microbatch``: the two-pass gradient-cache step (pass 1
    encodes each microbatch under ``torch.no_grad`` and keeps only z; dL/dz
    is taken on the small [2B, out_dim] matrix; pass 2 re-encodes each
    microbatch with grad and back-propagates its slice of dL/dz). Instance
    norm couples no samples, so it is the monolithic step's gradient, summed
    over the microbatches in another order.
  * ``remat``: ``torch.utils.checkpoint`` (non-reentrant) around the model.
  * ``mesh``: data parallel over the process group (one rank per device).
    Every rank runs ``fit`` over the same seeded path order and decodes
    only its block of each batch's rows; it draws the whole batch's
    augmentation uniforms and takes its rows' (every op is per image, so
    its views are the single-device views of those rows). The projections
    are all-gathered through ``parallel/bag_shard.AllGather`` (whose
    backward sums every rank's cotangent and keeps this rank's slice),
    every rank computes the same full-batch NT-Xent, and the gradients are
    averaged over the group before each rank's Adam step, so the
    parameters stay equal on every rank. Rank 0 alone logs and writes.

The recipe is the reference's: Adam(lr 1e-5, wd 1e-5) (simclr.py:72,
config.yaml weight_decay '10e-6'), a constant lr through 10 warm-up epochs
then cosine (simclr.py:77,129-130), a 90/10 split (config.yaml valid_size),
and the best-validation ``model.pth`` in the SimCLR layout, which
compute_feats' surgery loads.

Random streams: the split is ``np.random.default_rng(seed).permutation``
and each epoch's order ``np.random.default_rng([seed, epoch]).permutation``,
as in the JAX package, so the data order is bitwise its own. The
augmentation draws come from a CPU ``torch.Generator`` seeded from (seed,
epoch) in place of JAX's keys; each step draws from it.

Resume (``resume=True``): the model and Adam ``state_dict``s, the
generator's state and the counters are saved at every epoch end (and every
``save_every_n_steps`` steps) through ``io/native_ckpt``, so a resumed run
continues the uninterrupted one exactly. The state is replicated, so one
saved at any world size resumes at any other. The JAX package's legacy orbax
layout has no counterpart: this package never wrote it and cannot read
orbax, so such a state, like any unreadable or foreign one, starts training
from scratch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpumil_torch.data.patches import PatchBatchLoader
from tpumil_torch.io import native_ckpt
from tpumil_torch.models import simclr
from tpumil_torch.models.simclr import SimCLR, SimCLRConfig
from tpumil_torch.ops.augment import augment_pair_batch, draw_uniforms
from tpumil_torch.ops.nt_xent import l2_normalize, nt_xent_loss
from tpumil_torch.parallel import mesh as pmesh
from tpumil_torch.train.optim import adam_torch, cosine_annealing_lr, set_lr
from tpumil_torch.utils.device import select_device


@dataclasses.dataclass
class SimCLRTrainConfig:
    batch_size: int = 512            # config.yaml uses 4096; scale per card
    epochs: int = 100                # config.yaml
    eval_every_n_epochs: int = 1
    lr: float = 1e-5                 # simclr.py:72
    weight_decay: float = 1e-5       # config.yaml '10e-6'
    temperature: float = 0.5         # config.yaml loss.temperature
    use_cosine_similarity: bool = True
    valid_size: float = 0.1
    s: float = 1.0                   # color-jitter strength (config.yaml dataset.s)
    warmup_epochs: int = 10          # scheduler stepped only after epoch 10
    input_size: int = 224
    seed: int = 0
    log_every_n_steps: int = 25
    num_workers: int = 8
    # recompute the model's activations in the backward pass: less
    # activation memory for more operations
    remat: bool = False
    # the gradient-cache two-pass step at O(microbatch) activation memory
    # (the module docstring); what runs the reference's batch_size 4096
    # (simclr/config.yaml:1) on one card
    grad_cache_microbatch: Optional[int] = None
    # also save crash-resume state every N train steps (epoch-end saves
    # always happen); not part of the resume fingerprint: the cadence may
    # change between runs of the same experiment
    save_every_n_steps: Optional[int] = None


def check_config(cfg: SimCLRTrainConfig, n: int = 1) -> None:
    """The JAX trainer's refusals for a data-parallel mesh of ``n`` ranks
    (1: none)."""
    if cfg.batch_size % n:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by the "
            f"data-parallel mesh size {n} (sharded batches split evenly "
            f"over devices)")
    mb = cfg.grad_cache_microbatch
    if mb is not None and cfg.batch_size % mb:
        raise ValueError(f"grad_cache_microbatch {mb} must divide "
                         f"batch_size {cfg.batch_size}")
    if mb is not None and mb % n:
        raise ValueError(f"grad_cache_microbatch {mb} must be divisible "
                         f"by the mesh size {n}")


class SimCLRTrainer:
    def __init__(self, model_cfg: SimCLRConfig, cfg: SimCLRTrainConfig,
                 mesh=None, device: Optional[torch.device] = None):
        n = 1 if mesh is None else int(mesh.size())
        check_config(cfg, n)
        if mesh is not None and n != pmesh.world_size():
            raise ValueError(f"a data-parallel SimCLR mesh must span the "
                             f"process group ({pmesh.world_size()} ranks), "
                             f"got {n}")
        self.mesh = mesh
        self.n_shard = n
        self.model_cfg = model_cfg
        self.cfg = cfg
        # None: the card (select_device("cuda"), which raises without one)
        self.device = select_device("cuda") if device is None else device

    # -- the step ---------------------------------------------------------

    def init(self, seed: int) -> Tuple[SimCLR, torch.optim.Optimizer]:
        model = simclr.init_model(seed, self.model_cfg, self.device)
        return model, self.optimizer(model)

    def optimizer(self, model: SimCLR) -> torch.optim.Optimizer:
        return adam_torch(model.parameters(), betas=(0.9, 0.999),
                          weight_decay=self.cfg.weight_decay)

    def encode(self, model: SimCLR, u: torch.Tensor, images: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniforms ``[2, B, N_UNIFORMS]`` and uint8 images ``[B, S, S, 3]``
        -> the normalized projections of the two views; a slice of (u along
        B, images) gives the slice of z."""
        cfg = self.cfg
        if images.dtype != torch.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        v1, v2 = augment_pair_batch(images.float() / 255, u, cfg.input_size,
                                    self.model_cfg.compute_dtype, cfg.s)
        if cfg.remat:
            def fwd(v):
                return checkpoint(model, v, use_reentrant=False)
        else:
            fwd = model
        _, z1 = fwd(v1)
        _, z2 = fwd(v2)
        return l2_normalize(z1), l2_normalize(z2)

    def loss_from_z(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return nt_xent_loss(z1, z2, self.cfg.temperature,
                            self.cfg.use_cosine_similarity)

    def _encode_microbatches(self, model, u, images, mb):
        with torch.no_grad():
            zs = [self.encode(model, u[:, i:i + mb], images[i:i + mb])
                  for i in range(0, images.shape[0], mb)]
        return (torch.cat([z[0] for z in zs]), torch.cat([z[1] for z in zs]))

    def _whole_batch(self, z1: torch.Tensor, z2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's projections -> the whole batch's, in row order (one
        all-gather; autograd-aware)."""
        if self.mesh is None:
            return z1, z2
        from tpumil_torch.parallel.bag_shard import AllGather

        d = z1.shape[1]
        z = AllGather.apply(torch.cat([z1, z2], dim=1), None).flatten(0, 1)
        return z[:, :d], z[:, d:]

    @property
    def _microbatch(self) -> Optional[int]:
        """Each rank's share of the grad-cache microbatch."""
        mb = self.cfg.grad_cache_microbatch
        return None if mb is None else mb // self.n_shard

    def train_step(self, model: SimCLR, opt: torch.optim.Optimizer,
                   u: torch.Tensor, images: torch.Tensor,
                   lr: float) -> torch.Tensor:
        """One optimizer step on one batch (with a mesh, this rank's rows
        of it and of its uniforms); returns the loss (a 0-d device tensor,
        no host sync)."""
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        mb = self._microbatch
        if mb is None:
            loss = self.loss_from_z(*self._whole_batch(
                *self.encode(model, u, images)))
            loss.backward()
        else:
            z1, z2 = self._encode_microbatches(model, u, images, mb)
            z1.requires_grad_()
            z2.requires_grad_()
            loss = self.loss_from_z(*self._whole_batch(z1, z2))
            dz1, dz2 = torch.autograd.grad(loss, (z1, z2))
            for i in range(0, images.shape[0], mb):
                s = slice(i, i + mb)
                torch.autograd.backward(
                    self.encode(model, u[:, s], images[s]), (dz1[s], dz2[s]))
        if self.mesh is not None:
            from tpumil_torch.parallel.bag_shard import average_gradients

            average_gradients(list(model.parameters()), None)
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, model: SimCLR, u: torch.Tensor,
                  images: torch.Tensor) -> torch.Tensor:
        """The validation loss of one batch (with a mesh, of this rank's
        rows): microbatched when the microbatch divides it."""
        mb = self._microbatch
        if mb is not None and images.shape[0] % mb == 0:
            z1, z2 = self._encode_microbatches(model, u, images, mb)
        else:
            z1, z2 = self.encode(model, u, images)
        return self.loss_from_z(*self._whole_batch(z1, z2))

    # -- the schedule -----------------------------------------------------

    def _valid_batch_size(self, n_valid: int) -> int:
        """Validation batch size: the largest multiple of the batch unit
        that fits ``n_valid``, capped at batch_size. The unit is the
        grad-cache microbatch when set (so eval_step always takes the
        O(microbatch) path; a non-multiple would encode the whole batch at
        once and run out of memory at exactly the scales grad-cache
        enables), else the mesh size (a batch splits evenly over the
        ranks). 0 = skip validation this epoch."""
        unit = self.cfg.grad_cache_microbatch or self.n_shard
        return min(self.cfg.batch_size, (n_valid // unit) * unit)

    def lr_at(self, epoch: int) -> float:
        """Constant through the warmup epochs, cosine afterwards
        (simclr.py:77,129-130: scheduler stepped at end of epochs >= 10)."""
        c = self.cfg
        if epoch <= c.warmup_epochs:
            return c.lr
        return cosine_annealing_lr(c.lr, c.epochs, 0.0)(epoch - c.warmup_epochs)

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The augmentation draws of ``epoch``: a CPU generator seeded from
        (seed, epoch), so a resumed epoch draws what the uninterrupted one
        drew."""
        seed = np.random.SeedSequence([self.cfg.seed + 1, epoch]) \
            .generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def _fingerprint(self) -> str:
        """Experiment identity for --resume: every field that shapes the
        training trajectory."""
        m, c = self.model_cfg, self.cfg
        return (f"{m.base_model}|{m.out_dim}|{m.compute_dtype}|"
                f"{c.batch_size}|{c.lr}|{c.weight_decay}|{c.temperature}|"
                f"{c.use_cosine_similarity}|{c.valid_size}|{c.warmup_epochs}|"
                f"{c.input_size}|{c.seed}|{c.s}|{c.epochs}")

    def _images(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rows(self, paths: Sequence[str], batch: int, first: int,
              end: int) -> list:
        """This rank's block of the rows of batches ``first``..``end - 1``
        of ``batch`` paths each (all of them without a mesh)."""
        b, r = batch // self.n_shard, self._rank
        return [p for i in range(first, end)
                for p in paths[i * batch + r * b:i * batch + (r + 1) * b]]

    def _mine(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch's uniforms [2, B, ...]."""
        b, r = u.shape[1] // self.n_shard, self._rank
        return u[:, r * b:(r + 1) * b]

    @property
    def _rank(self) -> int:
        return 0 if self.mesh is None else pmesh.rank()

    def fit(self, patch_paths: Sequence[str], run_dir: str,
            log: Callable[[str], None] = print,
            fine_tune_from: Optional[str] = None,
            resume: bool = False) -> dict:
        """Pretrain on ``patch_paths``; ``resume=True`` continues from the
        train state under ``run_dir/state`` (the module docstring). With a
        mesh, every rank calls it with the same arguments."""
        from tpumil_torch.io import torch_ckpt
        from tpumil_torch.utils.prof import ScalarLogger, ThroughputMeter

        cfg = self.cfg
        main = self._rank == 0
        # a mesh's ranks save and load the replicated state together
        save_train_state, load_train_state = (
            (native_ckpt.save_train_state, native_ckpt.load_train_state)
            if self.mesh is None else
            (native_ckpt.save_sharded_train_state,
             native_ckpt.load_sharded_train_state))
        if not main:
            log = lambda s: None  # noqa: E731 - rank 0 alone logs
        rng = np.random.default_rng(cfg.seed)
        paths = list(patch_paths)
        indices = rng.permutation(len(paths))
        split = int(np.floor(cfg.valid_size * len(paths)))
        valid_paths = [paths[i] for i in indices[:split]]
        train_paths = [paths[i] for i in indices[split:]]

        model, opt = self.init(cfg.seed)
        if fine_tune_from:
            # reference semantics (simclr.py:133-142): the YAML value is a
            # RUN NAME resolved to ./runs/<name>/checkpoints/model.pth; a
            # direct .pth path also works; failure warns, never silently
            # trains from scratch
            cands = [fine_tune_from,
                     os.path.join("runs", fine_tune_from, "checkpoints",
                                  "model.pth")]
            found = next((c for c in cands if os.path.isfile(c)), None)
            if found:
                simclr.load_state_dict(model,
                                       torch_ckpt.load_state_dict(found))
                opt = self.optimizer(model)
                log("Loaded pre-trained model with success.")
            else:
                log("Pre-trained weights not found. Training from scratch.")

        ckpt_dir = os.path.join(run_dir, "checkpoints")
        state_dir = os.path.join(run_dir, "state")
        scalars = None
        if main:
            os.makedirs(ckpt_dir, exist_ok=True)
            scalars = ScalarLogger(run_dir)  # SummaryWriter (simclr.py:36)

        def scalar(tag, value, step):
            if scalars is not None:
                scalars.log(tag, value, step)

        meter = ThroughputMeter("patches")
        best_valid = float("inf")
        start_epoch = 0
        start_batch = 0
        resume_gen = None
        history = {"train_loss": [], "valid_loss": []}
        if resume and (os.path.isdir(state_dir)
                       or os.path.isdir(state_dir + ".prev")):
            try:
                st, meta = load_train_state(state_dir, map_location="cpu")
            except Exception as e:  # unreadable state: a fresh start
                log(f"Train state under {state_dir} is unreadable ({e!r}).")
                st, meta = None, {}
            if st is not None and \
                    meta.get("fingerprint") == self._fingerprint():
                model.load_state_dict(st["model"])
                opt.load_state_dict(st["optimizer"])
                start_epoch = int(meta["epoch"])
                start_batch = int(meta.get("step_in_epoch", 0))
                if start_batch:
                    resume_gen = st["generator"]
                best_valid = float(meta["best_valid"])
                log(f"Resuming SimCLR pretraining at epoch {start_epoch}"
                    + (f" step {start_batch}" if start_batch else "")
                    + f" (best valid {best_valid:.4f}).")
            else:
                log("Existing train state was produced by a different "
                    "config; training from scratch.")
        n_batches_per_epoch = len(train_paths) // cfg.batch_size
        n_iter = start_epoch * n_batches_per_epoch + start_batch

        def save_state(epoch, step_in_epoch, gen):
            save_train_state(
                state_dir,
                {"model": model.state_dict(), "optimizer": opt.state_dict(),
                 "generator": gen.get_state()},
                meta={"fingerprint": self._fingerprint(),
                      "best_valid": float(best_valid),
                      "epoch": int(epoch),
                      "step_in_epoch": int(step_in_epoch),
                      "n_iter": int(n_iter)})

        for epoch in range(start_epoch, cfg.epochs):
            lr = self.lr_at(epoch)
            gen = self.epoch_generator(epoch)
            order = np.random.default_rng(
                [cfg.seed, epoch]).permutation(len(train_paths))
            epoch_paths = [train_paths[i] for i in order]
            # drop_last=True like the reference loader (dataset_wrapper.py:73)
            n_batches = len(epoch_paths) // cfg.batch_size
            # mid-epoch resume: skip the already-trained leading batches and
            # take over the generator exactly where the saved step left it
            skip = start_batch if epoch == start_epoch else 0
            if resume_gen is not None and skip:
                gen.set_state(resume_gen)
            step_in_epoch = skip
            loader = PatchBatchLoader(
                self._rows(epoch_paths, cfg.batch_size, skip, n_batches),
                cfg.batch_size // self.n_shard, cfg.input_size,
                cfg.num_workers)
            t0 = time.perf_counter()
            for images, _, _ in loader:
                u = self._mine(draw_uniforms(gen, cfg.batch_size))
                loss = self.train_step(model, opt, u, self._images(images),
                                       lr)
                meter.add(cfg.batch_size)
                if n_iter % cfg.log_every_n_steps == 0:
                    log(f"epoch {epoch} iter {n_iter} loss {float(loss):.4f} "
                        f"lr {lr:.2e} {meter}")
                    history["train_loss"].append(float(loss))
                    scalar("train_loss", float(loss), n_iter)
                n_iter += 1
                step_in_epoch += 1
                if (cfg.save_every_n_steps
                        and step_in_epoch < n_batches
                        and step_in_epoch % cfg.save_every_n_steps == 0):
                    save_state(epoch, step_in_epoch, gen)
            self._sync()
            dt = time.perf_counter() - t0
            if n_batches - skip:
                log(f"epoch {epoch}: "
                    f"{(n_batches - skip) * cfg.batch_size / dt:.0f} "
                    f"patches/sec (2 views each)")

            if epoch % cfg.eval_every_n_epochs == 0 and valid_paths:
                # full batches only: zero-padded fake images would dominate
                # NT-Xent and corrupt best-checkpoint selection
                v_bs = self._valid_batch_size(len(valid_paths))
                if v_bs == 0:
                    # skip ONLY the validation body: the epoch-end scalar
                    # log and crash-resume save below must still run
                    log(f"epoch {epoch}: validation skipped "
                        f"({len(valid_paths)} paths < the validation "
                        f"batch unit)")
                else:
                    v_loader = PatchBatchLoader(
                        self._rows(valid_paths, v_bs, 0,
                                   len(valid_paths) // v_bs),
                        v_bs // self.n_shard, cfg.input_size,
                        cfg.num_workers)
                    losses = [float(self.eval_step(
                        model, self._mine(draw_uniforms(gen, v_bs)),
                        self._images(images))) for images, _, _ in v_loader]
                    valid_loss = (float(np.mean(losses)) if losses
                                  else float("inf"))
                    history["valid_loss"].append(valid_loss)
                    scalar("validation_loss", valid_loss, epoch)
                    if valid_loss < best_valid:
                        best_valid = valid_loss
                        if main:
                            self.save(model,
                                      os.path.join(ckpt_dir, "model.pth"))
                        log("saved")
            scalar("cosine_lr_decay", lr, n_iter)
            # crash-resume state: model, Adam moments, generator, counters
            save_state(epoch + 1, 0, gen)
        ckpt_path = os.path.join(ckpt_dir, "model.pth")
        if main:
            scalars.close()
            if not os.path.exists(ckpt_path):
                # no validation split ever ran (tiny datasets): persist the
                # final weights so downstream stages always have a checkpoint
                self.save(model, ckpt_path)
                log("saved final params (no validation split)")
        if self.mesh is not None:
            pmesh.barrier()
        return {"best_valid_loss": best_valid, "history": history,
                "checkpoint": ckpt_path, "model": model}

    def save(self, model: SimCLR, path: str) -> None:
        from tpumil_torch.io import torch_ckpt

        torch_ckpt.save_state_dict(simclr.export_state_dict(model), path)
