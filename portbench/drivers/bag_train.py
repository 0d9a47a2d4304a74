"""Driver ``bag_train``: per-bag DSMIL training over a device-resident
cohort, as ``train_wsi``'s schemes run each epoch with a global store.

Set-up makes the cohort (``traffic/bags.py``) and the aggregator's weights
from the seed on the device, builds ``BagTrainer`` (``fused_threshold``
"auto", so a bag goes to K1-K3 only when the eager step would not fit the
card) and a ``DeviceBagStore``, and loads the weights into the program's
model. It then drives the model and optimizer through their first three
steps by the window's own call, ``train_epoch`` over a store (of one bag
each, three different bags, the largest among them), keeping each step's
loss, the first gradient as Adam holds it (its first moment over
``1 - beta1``) and the change of the parameters; then one warm-up epoch
over the whole store. The window runs whole epochs of
``train_epoch(model, opt, store, lr, rng)`` until ``--seconds`` have
passed, under the profiler: ``bag_step_device_ms`` is the device's busy
time over the bag steps run, and ``step_wall_ms.train`` the time to the
end of the last epoch over them.

The check: the plain reference (``reference/dsmil.py``) takes the same
initial weights and the same three bags, and the worst relative gap of the
three losses, of the first gradient's leaf norms and of the parameter
change's leaf norms is held to a limit each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, training
from portbench.reference import dsmil as ref
from portbench.traffic import bags as traffic_bags

FIRST_STEPS = 3


@dataclasses.dataclass
class State:
    cell: harness.Cell
    trainer: Any
    model: Any
    opt: Any
    store: Any
    lr: float
    rng: np.random.Generator
    sizes: np.ndarray
    p0: Dict[str, torch.Tensor]
    first_bags: List[Any]          # (feats, label) of the first steps
    observed: Dict[str, Any]
    hp: dict


def setup(cell: harness.Cell) -> State:
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    cfg, tp, dev = cell.config, cell.traffic, cell.device
    agg, opt_cfg = cfg["aggregator"], cfg["optimizer"]
    k, c, d = int(agg["feats_size"]), int(agg["num_classes"]), \
        int(agg["q_width"])
    sizes, labels = traffic_bags.draw(tp, cell.rng(1))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    feats = traffic_bags.features(int(offsets[-1]), k, cell.generator(2),
                                  dev)
    host = feats.cpu().numpy()
    del feats
    bags = [Bag(host[offsets[i]:offsets[i + 1]], labels[i], f"bag{i}")
            for i in range(len(sizes))]
    store = DeviceBagStore(bags, device=dev)
    # the first steps' bags: the largest, and two others from the seed
    big = int(np.argmax(sizes))
    others = cell.rng(3).choice(np.delete(np.arange(len(sizes)), big),
                                FIRST_STEPS - 1, replace=False)
    first = [big, *map(int, others)]
    first_bags = [(torch.from_numpy(host[offsets[i]:offsets[i + 1]].copy())
                   .to(dev), torch.from_numpy(labels[i]).to(dev))
                  for i in first]
    del host, bags

    trainer = BagTrainer(
        DSMILConfig(k, c, nonlinear=bool(agg["nonlinear_q"]),
                    passing_v=bool(agg["passing_v"])),
        weight_decay=float(opt_cfg["weight_decay"]),
        fused_threshold=cfg["fused_threshold"], device=dev)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    p0 = ref.make_params(k, c, d, cell.generator(4), dev)
    model.load_state_dict(p0)
    lr = float(opt_cfg["lr"])
    rng = cell.rng(5)

    observed: Dict[str, Any] = {"loss": []}
    named = dict(model.named_parameters())
    beta1 = float(opt_cfg["betas"][0])
    for step, i in enumerate(first):
        model, opt, loss = trainer.train_epoch(model, opt, store.subset([i]),
                                               lr, rng)
        observed["loss"].append(float(loss))
        if step == 0:
            observed["grad1"] = training.first_gradient_norms(
                opt, named, beta1)
    observed["delta"] = training.leaf_norms(
        {n: p.detach() - p0[n] for n, p in named.items()})
    # warm-up: one epoch over the whole store, every shape of the window
    trainer.train_epoch(model, opt, store, lr, rng)
    hp = {"k": k, "c": c, "d": d, "lr": lr,
          "betas": tuple(float(b) for b in opt_cfg["betas"]),
          "eps": float(opt_cfg["eps"]),
          "weight_decay": float(opt_cfg["weight_decay"])}
    return State(cell, trainer, model, opt, store, lr, rng, sizes, p0,
                 first_bags, observed, hp)


def window(state: State, seconds: float) -> harness.Window:
    trainer, store = state.trainer, state.store
    epochs, failed = 0, 0
    t0 = harness.now()
    while True:
        state.model, state.opt, loss = trainer.train_epoch(
            state.model, state.opt, store, state.lr, state.rng)
        epochs += 1
        failed += 0 if np.isfinite(loss) else store.num_bags
        elapsed = harness.now() - t0
        if elapsed >= seconds:
            break
    steps = epochs * store.num_bags
    return harness.Window(
        seconds=elapsed, attempted=steps, failed=failed,
        end_to_end={},
        counters={"steps": steps, "fused_dispatches":
                  trainer.fused_dispatches,
                  "dsmil": {"instances": epochs * int(state.sizes.sum()),
                            "bags": steps, "k": state.hp["k"],
                            "c": state.hp["c"], "d": state.hp["d"]}})


def observe(state: State) -> Dict[str, Any]:
    """The first steps' readings; frees the program's model, optimizer and
    store."""
    state.model = state.opt = state.store = state.trainer = None
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return state.observed


def reference(state: State, observed, precision: str) -> Dict[str, Any]:
    """The reference's readings of the first steps, in f32 ("stated") or
    in TF32 ("lower", the control)."""
    tf32 = precision == "lower"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        hp = state.hp
        params = {k: v.clone() for k, v in state.p0.items()}
        opt = ref.Adam(params, hp["lr"], hp["betas"], hp["eps"],
                       hp["weight_decay"])
        out: Dict[str, Any] = {"loss": []}
        for step, (f, y) in enumerate(state.first_bags):
            leaves = {k: v.detach().requires_grad_() for k, v in
                      params.items()}
            loss = ref.loss(leaves, f, y)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            out["loss"].append(float(loss.detach()))
            if step == 0:
                out["grad1"] = training.leaf_norms(
                    opt.effective_grads(params, grads))
            opt.step(params, grads)
        out["delta"] = training.leaf_norms(
            {k: params[k] - state.p0[k] for k in params})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return out


def compare(state: State, observed, readings) -> List[harness.Compared]:
    return training.compared(state.cell.spec["limits"], observed, readings)


def as_observed(state: State, observed, readings) -> Dict[str, Any]:
    """Reference readings in the program's place (the same form)."""
    return readings


def close(state: State) -> None:
    state.first_bags = []
