"""Driver ``simclr_step``: SimCLR pretraining steps of the patch embedder,
as ``simclr_train`` runs them, through ``SimCLRTrainer.train_step``.

Set-up makes a pool of tissue-like uint8 patches on the device from the
seed (``traffic/images.py``), the model's weights on the device, loads
them into the program's ``SimCLR`` model, and builds the trainer (batch,
grad-cache microbatch, temperature, Adam's lr and decay from the
configuration) and its optimizer. Every step takes a batch drawn from the
pool without replacement and its ``[2, B, 31]`` augmentation uniforms from
a generator on the device. Set-up drives the first three steps, keeping
each loss, the first gradient as Adam holds it (its first moment over
``1 - beta1``) and the parameters' change; they also warm every shape of
the window. The window runs steps until ``--seconds`` have passed;
``simclr_views_per_s`` is the views (two an image) of every step over the
time to the end of the last.

The check: the plain reference (``reference/simclr.py``) follows the same
three steps from the same weights, images and uniforms in true f32, and
the worst relative gap of the losses, and the leaves' gaps of the first
gradient's norms and of the change's norms, are held to a limit each.
The control is that reference in TF32, so the driver runs f32 steps only;
a bf16 cell needs a control of its own (PERF.md, Open questions).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, training
from portbench.reference import dsmil as ref_dsmil
from portbench.reference import simclr as ref
from portbench.traffic import images as traffic_images

FIRST_STEPS = 3
N_UNIFORMS = 31


@dataclasses.dataclass
class State:
    cell: harness.Cell
    trainer: Any
    model: Any
    opt: Any
    pool: torch.Tensor
    rng: np.random.Generator
    gen: torch.Generator
    p0: Dict[str, torch.Tensor]
    first: List[tuple]               # (pool rows, uniforms) of the first steps
    observed: Dict[str, Any]
    hp: dict


def _batch(state_rng, gen, n_pool: int, b: int, device):
    rows = torch.from_numpy(state_rng.choice(n_pool, b, replace=False)) \
        .to(device)
    u = torch.rand((2, b, N_UNIFORMS), generator=gen, device=device)
    return rows, u


def setup(cell: harness.Cell) -> State:
    from tpumil_torch.models.simclr import SimCLR, SimCLRConfig
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    cfg, tp, dev = cell.config, cell.traffic, cell.device
    m, o = cfg["model"], cfg["optimizer"]
    if m["compute_dtype"] != "f32":
        raise harness.BenchError(
            "simclr_step runs f32 steps (its control is TF32); "
            f"the configuration asks for {m['compute_dtype']}")
    pool = traffic_images.tissue(int(tp["pool"]), int(tp["size"]),
                                 cell.generator(1), dev)
    model_cfg = SimCLRConfig(base_model=m["base_model"],
                             out_dim=int(m["out_dim"]),
                             compute_dtype=torch.float32)
    train_cfg = SimCLRTrainConfig(
        batch_size=int(tp["batch"]), lr=float(o["lr"]),
        weight_decay=float(o["weight_decay"]),
        temperature=float(m["temperature"]),
        input_size=int(tp["size"]),
        grad_cache_microbatch=int(cfg["grad_cache_microbatch"]))
    trainer = SimCLRTrainer(model_cfg, train_cfg, device=dev)
    model = SimCLR(model_cfg, dev)
    p0 = ref.make_params(cell.generator(2), dev, model_cfg.num_ftrs,
                         model_cfg.out_dim)
    model.load_state_dict(p0)
    opt = trainer.optimizer(model)
    rng, gen = cell.rng(3), cell.generator(4)

    observed: Dict[str, Any] = {"loss": []}
    named = dict(model.named_parameters())
    beta1 = float(o["betas"][0])
    first = []
    for step in range(FIRST_STEPS):
        rows, u = _batch(rng, gen, pool.shape[0], train_cfg.batch_size, dev)
        first.append((rows, u))
        loss = trainer.train_step(model, opt, u, pool[rows], train_cfg.lr)
        observed["loss"].append(float(loss))
        if step == 0:
            observed["grad1"] = training.first_gradient_norms(
                opt, named, beta1)
    observed["delta"] = training.leaf_norms(
        {n: p.detach() - p0[n] for n, p in named.items()})
    hp = {"lr": train_cfg.lr, "betas": tuple(float(b) for b in o["betas"]),
          "eps": float(o["eps"]), "weight_decay": train_cfg.weight_decay,
          "temperature": train_cfg.temperature,
          "block": train_cfg.grad_cache_microbatch,
          "batch": train_cfg.batch_size,
          "size": train_cfg.input_size}
    return State(cell, trainer, model, opt, pool, rng, gen, p0, first,
                 observed, hp)


def window(state: State, seconds: float) -> harness.Window:
    hp = state.hp
    steps, failed = 0, 0
    t0 = harness.now()
    while True:
        rows, u = _batch(state.rng, state.gen, state.pool.shape[0],
                         hp["batch"], state.cell.device)
        loss = float(state.trainer.train_step(state.model, state.opt, u,
                                              state.pool[rows], hp["lr"]))
        steps += 1
        failed += 0 if np.isfinite(loss) else 1
        elapsed = harness.now() - t0
        if elapsed >= seconds:
            break
    views = 2 * hp["batch"] * steps
    return harness.Window(
        seconds=elapsed, attempted=steps, failed=failed,
        end_to_end={"simclr_views_per_s": views / elapsed},
        counters={"steps": steps,
                  "simclr": {"views": views, "size": hp["size"],
                             "dtype": "float32"}})


def observe(state: State) -> Dict[str, Any]:
    """The first steps' readings; frees the program's model, optimizer and
    trainer."""
    state.model = state.opt = state.trainer = None
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return state.observed


def reference(state: State, observed, precision: str) -> Dict[str, Any]:
    """The reference's readings of the first steps in true f32
    ("stated"), or in TF32 ("lower", the control)."""
    hp = state.hp
    tf32 = precision == "lower"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    params = {k: v.clone() for k, v in state.p0.items()}
    opt = ref_dsmil.Adam(params, hp["lr"], hp["betas"], hp["eps"],
                         hp["weight_decay"])
    out: Dict[str, Any] = {"loss": []}
    for step, (rows, u) in enumerate(state.first):
        loss, grads = ref.loss_and_grads(params, state.pool[rows], u,
                                         hp["temperature"],
                                         torch.float32, hp["block"])
        out["loss"].append(loss)
        if step == 0:
            out["grad1"] = training.leaf_norms(
                opt.effective_grads(params, grads))
        opt.step(params, grads)
    out["delta"] = training.leaf_norms(
        {k: params[k] - state.p0[k] for k in params})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def compare(state: State, observed, readings) -> List[harness.Compared]:
    return training.compared(state.cell.spec["limits"], observed, readings)


def as_observed(state: State, observed, readings) -> Dict[str, Any]:
    """Reference readings in the program's place (the same form)."""
    return readings


def close(state: State) -> None:
    state.pool = None
    state.first = []
