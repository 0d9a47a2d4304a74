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

import collections
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


def sharded_trainer_steps(state, compute_dtype, steps: int = 3,
                          lr: float = 2e-3):
    """``steps`` Adam steps of InstanceShardedBagTrainer over the whole world
    with a DSMILConfig of ``compute_dtype``, on step_bag()'s real rows (the
    trainer pads them to the 256 bucket and splits that over the ranks):
    (losses, parameters, optimizer state dtypes) of this rank, and the
    collective calls per step."""
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.parallel import bag_shard, mesh
    from tpumil_torch.train.optim import set_lr

    m = mesh.make_mesh(inst_parallel=mesh.world_size(), device_type="cpu")
    tr = bag_shard.InstanceShardedBagTrainer(
        DSMILConfig(64, 2, compute_dtype=compute_dtype), weight_decay=1e-3,
        device=CPU, mesh=m)
    model = dsmil_from(state, 64, 2)
    opt = tr.make_optimizer(model)
    set_lr(opt, lr)
    feats, mask, label = step_bag()
    item = (torch.from_numpy(feats[mask]), torch.from_numpy(label))
    losses = []
    bag_shard.collective.calls = 0
    for _ in range(steps):
        losses.append(float(tr._train_bags(model, opt, [item], False, None)))
    dtypes = {str(t.dtype) for st in opt.state.values() for t in st.values()
              if t.dim() > 0}
    return losses, params_of(model), dtypes, bag_shard.collective.calls // steps


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


def data_parallel_run(n_dev: int, compute_dtype=torch.float32):
    """DataParallelBagTrainer over make_mesh(n_dev) on ragged_bags(): two
    epochs and a predict (tests/test_parallel.py's invariance case), with a
    DSMILConfig of ``compute_dtype``."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.parallel import mesh
    from tpumil_torch.parallel.sharded_train import DataParallelBagTrainer

    tr = DataParallelBagTrainer(DSMILConfig(16, 1,
                                            compute_dtype=compute_dtype),
                                weight_decay=1e-3,
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
            "trainer_steps": {str(dt): sharded_trainer_steps(step_state, dt)
                              for dt in (torch.float32, torch.bfloat16)},
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


# -- the embedding half: data-parallel extraction, inference, serving and
# SimCLR (tests/test_torch_scale_out_embed.py) -------------------------------

EMBED_BATCH, EMBED_PATCH, BAG_BATCH = 8, 64, 4


def embedder_of(inputs):
    """The test's embedder: its backbone, the aggregator's instance head."""
    from tpumil_torch.io import torch_ckpt
    from tpumil_torch.models import embedder

    agg, agg_cfg, model = torch_ckpt.load_mil_pth(inputs["aggregator"], CPU)
    emb = embedder.Embedder(embedder.EmbedderConfig(
        num_classes=agg_cfg.num_classes), CPU)
    emb.feature_extractor.load_state_dict(inputs["backbone"], strict=True)
    fc = agg.i_classifier.fc
    fc = fc[0] if isinstance(fc, torch.nn.Sequential) else fc
    emb.set_head(fc.weight.detach(), fc.bias.detach())
    return emb, agg, model


def _refusals(m, emb, agg, model):
    """The messages of every refusal the world can show."""
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.heatmap import BagInference
    from tpumil_torch.infer.service import InferenceService
    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.parallel import mesh
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    calls = {
        "negative": lambda: mesh.data_parallel_mesh(-1, device_type="cpu"),
        "too_many": lambda: mesh.data_parallel_mesh(4, device_type="cpu"),
        "extractor": lambda: FeatureExtractor(emb, 7, mesh=m),
        "bag_inference": lambda: BagInference(emb, agg, batch_size=7,
                                              model=model, mesh=m),
        "service": lambda: InferenceService(emb, CPU, batch_size=7,
                                            patch_size=EMBED_PATCH, mesh=m),
        "simclr_batch": lambda: SimCLRTrainer(
            SimCLRConfig(), SimCLRTrainConfig(batch_size=7), mesh=m,
            device=CPU),
        "simclr_microbatch": lambda: SimCLRTrainer(
            SimCLRConfig(), SimCLRTrainConfig(batch_size=6,
                                              grad_cache_microbatch=3),
            mesh=m, device=CPU),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _simclr_steps(m, inputs):
    """One monolithic and one grad-cache (microbatch 4) SGD step at batch 8
    from the same weights and uniforms, each rank on its rows: (loss, the
    gradient before the step, the largest parameter gap to rank 0 after
    it) of each."""
    import torch.distributed as dist

    from tpumil_torch.models import simclr
    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    cfg32 = SimCLRConfig(compute_dtype=torch.float32)
    u, images = inputs["uniforms"], torch.from_numpy(inputs["views"])
    b = images.shape[0] // dist.get_world_size()
    rows = slice(dist.get_rank() * b, (dist.get_rank() + 1) * b)
    out = {}
    for mb in (None, 4):
        tr = SimCLRTrainer(cfg32, SimCLRTrainConfig(
            batch_size=images.shape[0], input_size=EMBED_PATCH, lr=1e-3,
            grad_cache_microbatch=mb), mesh=m, device=CPU)
        model = simclr.SimCLR(cfg32, CPU)
        model.load_state_dict(inputs["simclr"])
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        loss = tr.train_step(model, opt, u[:, rows], images[rows], 1e-3)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        out[mb] = (float(loss), {k: p.grad.clone() for k, p in
                                 model.named_parameters()}
                   if dist.get_rank() == 0 else None,
                   float((flat - ref).abs().max()))
    return out


def _simclr_fits(m, inputs, tmp):
    """SimCLR ``fit`` over the whole world: (1) the JAX package's skipped
    validation case (a valid split of 1 < the mesh's 2) still saves its
    resume state, and the same config resumes from it; (2) the resume
    config's run, its state after the first step kept aside; rank 0's logs
    of each run and the final parameters of (2)."""
    import shutil

    import torch.distributed as dist

    from tpumil_torch.io import native_ckpt
    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)
    from tpumil_torch.utils import prof

    prof._summary_writer = lambda logdir: None  # scalars.jsonl alone
    cfg32 = SimCLRConfig(compute_dtype=torch.float32)
    paths = inputs["fit_paths"]
    logs = []

    def fit(cfg, run, resume=False):
        lines = []
        out = SimCLRTrainer(cfg32, cfg, mesh=m, device=CPU).fit(
            paths, os.path.join(tmp, run), log=lines.append, resume=resume)
        logs.append(lines)
        return out

    cfg = SimCLRTrainConfig(batch_size=4, epochs=1, input_size=48,
                            num_workers=2, log_every_n_steps=100)
    fit(cfg, "skip")
    state = os.path.isdir(os.path.join(tmp, "skip", "state"))
    fit(cfg, "skip", resume=True)

    save, saves = native_ckpt.save_sharded_train_state, [0]

    def keep_first(path, st, *, meta=None):
        save(path, st, meta=meta)
        saves[0] += 1
        if saves[0] == 1 and dist.get_rank() == 0:
            shutil.copytree(path, os.path.join(tmp, "snapshot"))

    native_ckpt.save_sharded_train_state = keep_first
    try:
        out = fit(inputs["resume_cfg"], "straight")
    finally:
        native_ckpt.save_sharded_train_state = save
    return logs, state, params_of(out["model"])


def embed_world(inputs_path: str, tmp: str):
    """Everything the data-parallel embedding tests read, from one world:
    the refusals, FeatureExtractor.embed_paths / embed_arrays,
    BagInference.run_bag, InferenceService rows (one request, then the
    same rows packed as two), the SimCLR steps and fits. Rank 0 returns the
    results; the followers' SimCLR gaps to rank 0 come back too."""
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.heatmap import BagInference
    from tpumil_torch.infer.service import InferenceService
    from tpumil_torch.parallel import mesh
    from tpumil_torch.utils import prof

    inputs = torch.load(inputs_path, weights_only=False)
    m = mesh.data_parallel_mesh(mesh.world_size(), device_type="cpu")
    emb, agg, model = embedder_of(inputs)
    out = {"refusals": _refusals(m, emb, agg, model)}
    ex = FeatureExtractor(emb, EMBED_BATCH, EMBED_PATCH, 2, mesh=m)
    bags = BagInference(emb, agg, batch_size=BAG_BATCH,
                        patch_size=EMBED_PATCH, num_workers=2, model=model,
                        mesh=m)
    mesh.feed_collective.calls = 0
    prof.collect()
    with prof.recording():
        out["embedded"] = mesh.lead(m, lambda: {
            "paths": ex.embed_paths(inputs["paths"]),
            "arrays": ex.embed_arrays(inputs["arrays"]),
            "bag": bags.run_bag(inputs["bag"])})
    out["feed_calls"] = mesh.feed_collective.calls
    out["feed_spans"] = dict(collections.Counter(
        s.name for s in prof.collect() if s.name.startswith("mesh.")))
    svc = InferenceService(emb, CPU, batch_size=EMBED_BATCH,
                           patch_size=EMBED_PATCH, max_wait_ms=5.0, mesh=m)
    if mesh.is_main():
        images = inputs["images"]
        try:
            whole = svc.embed(images)
            parts = [svc._batcher.submit(images[:5]),
                     svc._batcher.submit(images[5:])]
            out["served"] = (whole, np.concatenate(
                [p.result(120)[:, :whole.shape[1]] for p in parts]))
        finally:
            svc.close()
    else:
        mesh.follow()
    out["steps"] = _simclr_steps(m, inputs)
    out["fits"] = _simclr_fits(m, inputs, tmp)
    if not mesh.is_main():  # the followers' gaps alone: no copies of weights
        return {"gaps": [v[2] for v in out["steps"].values()]}
    return out
