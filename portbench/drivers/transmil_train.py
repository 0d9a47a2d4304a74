"""Driver ``transmil_train``: per-bag TransMIL training over a
device-resident cohort, as ``train_wsi --model transmil`` runs each epoch
with a global store.

Set-up builds ``BagTrainer(model="transmil")`` first (a program without
the model fails here, before any data is made), then the cohort
(``traffic/bags.py``, 1024-d features) and a ``DeviceBagStore``, and the
weights from the seed on the device (``reference/transmil.py``), loaded
into the program's model; the optimizer is the trainer's, Lookahead around
RAdam. It then drives the model and optimizer through their first three
steps by the window's own call, ``train_epoch`` over a store of one bag
each (the largest bag, and two others from the seed), dropout on, keeping
each loss, the first gradient as RAdam holds it (its first moment over
``1 - beta1``), the change of the parameters, and the seed of each step's
dropout generator; then one warm-up epoch over the whole store. The window
runs whole epochs of ``train_epoch(model, opt, store, lr, rng)`` until
``--seconds`` have passed, under the profiler: ``bag_step_device_ms`` is
the device's busy time over the bag steps run.

The check: the plain reference takes the same initial weights, the same
three bags and dropout generators seeded alike (so the same keep masks),
and Lookahead(RAdam) written out; the worst relative gap of the three
losses, of the first gradient's leaf norms and of the parameter change's
leaf norms is held to a limit each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, training
from portbench.reference import transmil as ref
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
    first_bags: List[Any]          # (feats, label, dropout seed) a step
    observed: Dict[str, Any]
    hp: dict


def _trainer(cfg: dict, dev):
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    agg = cfg["aggregator"]
    try:
        return BagTrainer(
            DSMILConfig(int(agg["feats_size"]), int(agg["num_classes"])),
            weight_decay=float(cfg["optimizer"]["weight_decay"]),
            model=agg["model"], device=dev)
    except ValueError as e:  # a program without the model
        raise harness.BenchError(f"the program cannot train "
                                 f"{agg['model']!r}: {e}") from None


def setup(cell: harness.Cell) -> State:
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.data.device_store import DeviceBagStore

    cfg, tp, dev = cell.config, cell.traffic, cell.device
    agg, opt_cfg = cfg["aggregator"], cfg["optimizer"]
    trainer = _trainer(cfg, dev)
    k, c = int(agg["feats_size"]), int(agg["num_classes"])
    sizes, labels = traffic_bags.draw(tp, cell.rng(1))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    feats = traffic_bags.features(int(offsets[-1]), k, cell.generator(2),
                                  dev)
    host = feats.cpu().numpy()
    del feats
    bags = [Bag(host[offsets[i]:offsets[i + 1]], labels[i], f"bag{i}")
            for i in range(len(sizes))]
    store = DeviceBagStore(bags, device=dev)
    big = int(np.argmax(sizes))
    others = cell.rng(3).choice(np.delete(np.arange(len(sizes)), big),
                                FIRST_STEPS - 1, replace=False)
    first = [big, *map(int, others)]
    first_feats = [(torch.from_numpy(host[offsets[i]:offsets[i + 1]].copy())
                    .to(dev), torch.from_numpy(labels[i]).to(dev))
                   for i in first]
    del host, bags

    model, opt = trainer.init(torch.Generator().manual_seed(0))
    arch = {"dim": agg["hidden_dim"], "heads": agg["heads"],
            "landmarks": agg["landmarks"],
            "pinv_iterations": agg["pinv_iterations"],
            "conv_taps": agg["residual_conv_taps"], "dropout": agg["dropout"]}
    built = {key: getattr(model.arch, key) for key in arch}
    if built != arch:
        raise harness.BenchError(f"the program builds TransMIL as {built}, "
                                 f"the configuration states {arch}")
    p0 = ref.make_params(k, c, cell.generator(4), dev,
                         dim=int(agg["hidden_dim"]), heads=int(agg["heads"]),
                         taps=int(agg["residual_conv_taps"]))
    model.load_state_dict(p0)
    opt = trainer.make_optimizer(model)  # Lookahead's slow weights from p0
    lr = float(opt_cfg["lr"])
    rng = cell.rng(5)

    # the dropout generator's seed of each step, as the trainer draws it
    seeds: List[int] = []
    make = trainer._generator
    trainer._generator = lambda seed: (seeds.append(seed), make(seed))[1]
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
    del trainer._generator
    observed["delta"] = training.leaf_norms(
        {n: p.detach() - p0[n] for n, p in named.items()})
    # warm-up: one epoch over the whole store, every shape of the window
    trainer.train_epoch(model, opt, store, lr, rng)
    hp = {"k": k, "c": c, "lr": lr, "d": int(agg["hidden_dim"]),
          "heads": int(agg["heads"]), "landmarks": int(agg["landmarks"]),
          "iterations": int(agg["pinv_iterations"]),
          "taps": int(agg["residual_conv_taps"]),
          "dropout": float(agg["dropout"]),
          "betas": tuple(float(b) for b in opt_cfg["betas"]),
          "eps": float(opt_cfg["eps"]),
          "weight_decay": float(opt_cfg["weight_decay"]),
          "lookahead": (int(opt_cfg["lookahead_k"]),
                        float(opt_cfg["lookahead_alpha"]))}
    first_bags = [(f, y, s) for (f, y), s in zip(first_feats, seeds)]
    return State(cell, trainer, model, opt, store, lr, rng, sizes, p0,
                 first_bags, observed, hp)


def window(state: State, seconds: float) -> harness.Window:
    trainer, store, hp = state.trainer, state.store, state.hp
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
        counters={"steps": steps,
                  "transmil": {"instances": epochs * int(state.sizes.sum()),
                               "bags": steps, "epochs": epochs,
                               "sizes": [int(n) for n in state.sizes],
                               "k": hp["k"], "c": hp["c"], "d": hp["d"],
                               "heads": hp["heads"],
                               "landmarks": hp["landmarks"],
                               "iterations": hp["iterations"],
                               "taps": hp["taps"]}})


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
    hp, dev = state.hp, state.cell.device
    try:
        params = {k: v.clone() for k, v in state.p0.items()}
        opt = ref.LookaheadRAdam(params, hp["lr"], hp["betas"], hp["eps"],
                                 hp["weight_decay"], *hp["lookahead"])
        out: Dict[str, Any] = {"loss": []}
        for step, (f, y, seed) in enumerate(state.first_bags):
            leaves = {k: v.detach().requires_grad_() for k, v in
                      params.items()}
            gen = torch.Generator(device=dev).manual_seed(seed)
            loss = ref.loss(leaves, f, y, gen, p_drop=hp["dropout"],
                            landmarks=hp["landmarks"],
                            iters=hp["iterations"], tf32=tf32)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            out["loss"].append(float(loss.detach()))
            if step == 0:
                out["grad1"] = training.leaf_norms(grads)
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
