"""Spawned gloo worlds for the port's multi-process tests
(tests/test_torch_parallel.py, test_torch_schemes.py, test_torch_mil_bench.py).

``run_world(world, fn, *args, tmp=...)`` starts ``world`` processes, joins
them into one gloo process group over a ``file://`` store under ``tmp``,
runs ``fn(*args)`` on each (``fn`` a function of this module, importable by
the spawned children, which import torch and the port but never JAX), and
returns every rank's result, in rank order. A rank that raises fails the
call; a world that does not finish within ``timeout`` seconds is killed and
fails it too, so a hung collective fails its test instead of stalling the
suite. The children's process groups time out their collectives after 60 s.

Several checks share one world: each spawn costs a few seconds.
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

CPU = torch.device("cpu")


def run_world(world: int, fn, *args, tmp, timeout: float = 120.0):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{fn.__name__}_{world}")
    outs = [os.path.join(tmp, f"out_{fn.__name__}_{world}_{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(r, world, store, fn, args,
                                               outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"world of {world} running {fn.__name__} did "
                               f"not finish in {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {fn.__name__} wrote no result "
                               f"(exit code {procs[r].exitcode})")
        ok, value = torch.load(path, weights_only=False)
        if not ok:
            raise RuntimeError(f"rank {r} of {fn.__name__} raised:\n{value}")
        results.append(value)
    return results


def _entry(rank, world, store, fn, args, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        try:
            result = (True, fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = (False, traceback.format_exc())
    torch.save(result, out)


def run_cli(module: str, argv, cwd, timeout: float = 180.0):
    """``python -m module argv`` in ``cwd`` with the repo on the path and
    one thread per process, its whole process group killed after
    ``timeout`` s. Returns stdout; a non-zero exit raises with both
    streams."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one intra-op thread per process: the command and its workers share
    # the cores with the test run's own workers
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}:\n{out}\n{err}")
    return out


# -- inputs, the same in the test process and in the workers ----------------

def forward_bag(k: int = 64, n: int = 128, n_valid: int = 100):
    """tests/test_parallel.py's forward-parity bag: n rows, the last
    n - n_valid zero padding."""
    rng = np.random.default_rng(0)
    feats = np.zeros((n, k), np.float32)
    feats[:n_valid] = rng.standard_normal((n_valid, k))
    return feats, np.arange(n) < n_valid


def step_bag(k: int = 64, n: int = 256, n_valid: int = 229):
    """tests/test_parallel.py's train-step bag."""
    rng = np.random.default_rng(1)
    feats = np.zeros((n, k), np.float32)
    feats[:n_valid] = rng.standard_normal((n_valid, k))
    return feats, np.arange(n) < n_valid, np.asarray([1.0, 0.0], np.float32)


def epoch_bags(sizes=(10, 33, 64, 100, 17, 50), k: int = 32, seed: int = 2):
    """tests/test_parallel.py's epoch bags: (feats, label, name)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, k)).astype(np.float32),
             np.asarray([float(i % 2), float((i + 1) % 2)], np.float32),
             f"b{i}") for i, n in enumerate(sizes)]


def ragged_bags():
    """tests/test_parallel.py's ragged 5-bag data-parallel case."""
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((sz, 16)).astype(np.float32),
             np.asarray([float(i % 2)], np.float32), f"b{i}")
            for i, sz in enumerate([20, 33, 41, 28, 37])]


def dsmil_from(state, k: int, c: int):
    from tpumil_torch.models.dsmil import DSMIL, DSMILConfig

    model = DSMIL(DSMILConfig(k, c), CPU)
    model.load_state_dict(state)
    return model


def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- worker bodies -----------------------------------------------------------

def sharded_forward(state, inst: int):
    """The inst-sharded forward of forward_bag() on a (world / inst, inst)
    mesh."""
    from tpumil_torch.parallel import bag_shard, mesh

    m = mesh.make_mesh(inst_parallel=inst, device_type="cpu")
    feats, mask = forward_bag()
    f, msk = bag_shard.shard_bag(m, torch.from_numpy(feats),
                                 torch.from_numpy(mask))
    out = bag_shard.make_instance_sharded_forward(m)(dsmil_from(state, 64, 2),
                                                     f, msk)
    return [t.detach() for t in out]


def sharded_steps(state, steps: int = 3, lr: float = 2e-3):
    """``steps`` inst-sharded Adam steps on step_bag() over the whole world;
    (losses, parameters) of this rank, and the collective calls per
    step."""
    from tpumil_torch.parallel import bag_shard, mesh

    m = mesh.make_mesh(inst_parallel=mesh.world_size(), device_type="cpu")
    step, make_opt = bag_shard.make_instance_sharded_train_step(m)
    model = dsmil_from(state, 64, 2)
    opt = make_opt(model.parameters())
    feats, mask, label = step_bag()
    f, msk = bag_shard.shard_bag(m, torch.from_numpy(feats),
                                 torch.from_numpy(mask))
    losses = []
    bag_shard.collective.calls = 0
    for _ in range(steps):
        model, opt, loss = step(model, opt, f, msk, torch.from_numpy(label),
                                lr=lr)
        losses.append(float(loss))
    return losses, params_of(model), bag_shard.collective.calls // steps


def sharded_epoch(state, seed: int = 9, lr: float = 2e-3):
    """One train_bags_sharded epoch over epoch_bags() in the permutation of
    ``default_rng(seed)``, over the whole world."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.parallel import bag_shard, mesh

    m = mesh.make_mesh(inst_parallel=mesh.world_size(), device_type="cpu")
    step, make_opt = bag_shard.make_instance_sharded_train_step(m)
    model = dsmil_from(state, 32, 2)
    opt = make_opt(model.parameters())
    bags = [Bag(*b) for b in epoch_bags()]
    model, opt, losses = bag_shard.train_bags_sharded(
        step, m, model, opt, bags, lr, np.random.default_rng(seed))
    return losses, params_of(model)


def sharded_epochs_saved(state, path: str, epochs: int = 3, save_at: int = 2):
    """``epochs`` train_bags_sharded epochs over the whole world, the
    sharded train state saved after ``save_at``; the final parameters."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.io import native_ckpt
    from tpumil_torch.parallel import bag_shard, mesh

    m = mesh.make_mesh(inst_parallel=mesh.world_size(), device_type="cpu")
    step, make_opt = bag_shard.make_instance_sharded_train_step(m)
    model = dsmil_from(state, 32, 2)
    opt = make_opt(model.parameters())
    bags = [Bag(*b) for b in epoch_bags(sizes=(24, 50, 64, 17), seed=4)]
    for e in range(epochs):
        if e == save_at:
            native_ckpt.save_sharded_train_state(
                path, {"params": model.state_dict(),
                       "opt_state": opt.state_dict()}, meta={"epoch": e})
        model, opt, _ = bag_shard.train_bags_sharded(
            step, m, model, opt, bags, 2e-3, np.random.default_rng([11, e]))
    return params_of(model)


def resume_epochs(path: str, epochs: int = 3):
    """Load the sharded state at ``path`` and run the remaining epochs of
    sharded_epochs_saved() over the whole world."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.io import native_ckpt
    from tpumil_torch.parallel import bag_shard, mesh

    m = mesh.make_mesh(inst_parallel=mesh.world_size(), device_type="cpu")
    step, make_opt = bag_shard.make_instance_sharded_train_step(m)
    st, meta = native_ckpt.load_sharded_train_state(path, CPU)
    model = dsmil_from(st["params"], 32, 2)
    opt = make_opt(model.parameters())
    opt.load_state_dict(st["opt_state"])
    bags = [Bag(*b) for b in epoch_bags(sizes=(24, 50, 64, 17), seed=4)]
    for e in range(meta["epoch"], epochs):
        model, opt, _ = bag_shard.train_bags_sharded(
            step, m, model, opt, bags, 2e-3, np.random.default_rng([11, e]))
    return params_of(model)


def data_parallel_run(n_dev: int):
    """DataParallelBagTrainer over make_mesh(n_dev) on ragged_bags(): two
    epochs and a predict (tests/test_parallel.py's invariance case)."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.parallel import mesh
    from tpumil_torch.parallel.sharded_train import DataParallelBagTrainer

    tr = DataParallelBagTrainer(DSMILConfig(16, 1), weight_decay=1e-3,
                                device=CPU,
                                mesh=mesh.make_mesh(n_dev, device_type="cpu"))
    model, opt = tr.init(torch.Generator().manual_seed(0))
    bags = [Bag(*b) for b in ragged_bags()]
    erng = np.random.default_rng(3)
    losses = []
    for _ in range(2):
        model, opt, loss = tr.train_epoch(model, opt, bags, 1e-3, erng)
        losses.append(loss)
    scores, _ = tr.predict(model, bags)
    return np.asarray(losses), scores, params_of(model)


def world_checks():
    """The checks of a whole world of 4 that need one: the world-size
    refusals, and a hybrid mesh of two 2-rank nodes."""
    from tpumil_torch.parallel import mesh

    import torch.distributed as dist

    errors = []
    for call in (lambda: mesh.take_devices(2, "cpu"),
                 lambda: mesh.make_mesh(8, device_type="cpu"),
                 lambda: mesh.make_mesh(4, inst_parallel=3,
                                        device_type="cpu"),
                 lambda: mesh.make_hybrid_mesh((1, 4), 1, "cpu")):
        os.environ["LOCAL_WORLD_SIZE"] = "2"  # two nodes of 2 ranks
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
    # two nodes of 2: inst groups of the ranks of one node, data across
    hybrid = mesh.make_hybrid_mesh((1, 2), 2, "cpu")
    return errors, (tuple(hybrid.shape),
                    dist.get_process_group_ranks(hybrid.get_group("inst")),
                    dist.get_process_group_ranks(hybrid.get_group("data")))


def world4(fwd_state, step_state, epoch_state):
    """Everything the world-of-4 test reads, from one spawn."""
    return {"errors": world_checks(),
            "fwd4": sharded_forward(fwd_state, 4),
            "fwd2": sharded_forward(fwd_state, 2),
            "steps": sharded_steps(step_state),
            "epoch": sharded_epoch(epoch_state),
            "dp": data_parallel_run(4)}


def world2(epoch_state, path: str):
    """The sharded state saved at world 2 (and the uninterrupted run's
    final parameters)."""
    return sharded_epochs_saved(epoch_state, path)


def schemes_runs(runs, bags):
    """run_5fold_cv over ``bags`` ((feats, label, name) tuples) on the CPU
    from every rank of the world, once per (WSITrainConfig fields,
    save_dir) of ``runs``; each run's result and the lines it logged."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.train import schemes

    out = []
    for cfg_kw, save_dir in runs:
        lines = []
        out.append((schemes.run_5fold_cv(
            [Bag(*b) for b in bags],
            schemes.WSITrainConfig(**cfg_kw, device=CPU), log=lines.append,
            save_dir=save_dir), lines))
    return out


def mil_run(cfg_kw: dict, path: str, num_feats: int, inits: dict):
    """run_mil_cv on the svmlight file at ``path`` from every rank, each
    fold's model initialised from ``inits[generator seed]`` (a dsmil
    state_dict)."""
    from tpumil_torch.data.mil_bench import parse_mil_file
    from tpumil_torch.models.dsmil import DSMIL
    from tpumil_torch.train import schemes
    from tpumil_torch.train.trainer import BagTrainer

    def init(self, generator):
        net = DSMIL(self.cfg, self.device)
        net.load_state_dict(inits[generator.initial_seed()])
        return net, self.make_optimizer(net)

    BagTrainer.init = init
    lines = []
    out = schemes.run_mil_cv(parse_mil_file(path, num_feats),
                             schemes.MILBenchConfig(**cfg_kw, device=CPU),
                             log=lines.append)
    return out, lines
