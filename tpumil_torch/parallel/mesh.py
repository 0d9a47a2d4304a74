"""Process groups and the (data, inst) device mesh (counterpart of
tpumil/parallel/mesh.py).

JAX drives every device of a mesh from one process; PyTorch runs one
process per device. The counterpart of a ``(data, inst)``
``jax.sharding.Mesh`` is a ``DeviceMesh`` with the same dimension names
over an initialised default process group, one rank per device:

  * ``data`` -- bags (data parallel): each rank owns a slice of a bag batch;
    gradients are summed by an all-reduce;
  * ``inst`` -- instances within a bag (sequence parallel): a giant bag's
    rows are split over the ranks of an ``inst`` group, and the masked
    argmax, the softmax over N and A^T V become collectives on
    ``mesh.get_group("inst")`` (parallel/bag_shard.py).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``, and no
other combination; each rank binds ``cuda:LOCAL_RANK``. A mesh of N devices
needs a process group of exactly N ranks: ``torchrun``, or :func:`launch`,
which the training CLIs use to start N local workers themselves. A world
of one needs no launcher: :func:`make_mesh` makes it when no group exists.

``bag_batch_sharding`` and ``replicated`` are JAX placement helpers with no
counterpart here: each rank holds its own tensors. ``data_parallel_mesh``
and ``make_batch_sharded_jit`` belong to the embedding half of scale-out
(ROADMAP Queue 1 item 4b) and come with their callers.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
INST_AXIS = "inst"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The one backend of ``device_type``; raises when this build of torch
    lacks it (a CUDA run never drops to gloo)."""
    if device_type not in BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}; expected one "
                         f"of {tuple(BACKENDS)}")
    backend = BACKENDS[device_type]
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a cuda process group needs NCCL, which this "
                           "build of torch lacks")
    return backend


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on rank 0, the one rank that writes files and logs."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_from_main(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a process
    group): decisions taken on values that two devices may compute a last
    bit apart must not split the ranks' control flow."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def take_devices(n: int, device_type: str = "cuda") -> None:
    """Check that a job of ``n`` devices can run here, failing LOUDLY when
    it cannot -- a run must never quietly become a run on fewer devices
    (e.g. --inst_shard 8 on a 4-card host). On ``cuda`` the host must have
    a card per local rank; inside a process group the world must hold
    exactly ``n`` ranks."""
    if n < 0:
        raise ValueError(f"device count must be non-negative, got {n}")
    world = dist.get_world_size() if dist.is_initialized() else None
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   n if world is None else world))
        count = torch.cuda.device_count()
        if count < local:
            raise ValueError(
                f"requested {local} devices but only {count} are available "
                f"({[f'cuda:{i}' for i in range(count)]})")
    if world is not None and world != n:
        if world < n:
            raise ValueError(f"requested {n} devices but only {world} are "
                             f"available (a process group of {world})")
        raise ValueError(f"requested {n} devices but the process group "
                         f"holds {world} ranks; start exactly {n}")


def default_inst_parallel(n: int) -> int:
    """The JAX package's default ``inst`` size: 2 when ``n`` is even and
    above 1, else 1."""
    return 2 if n % 2 == 0 and n > 1 else 1


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def make_mesh(n_devices: Optional[int] = None,
              inst_parallel: Optional[int] = None,
              device_type: str = "cuda"):
    """A ``(data, inst)`` ``DeviceMesh`` over the ``n_devices`` ranks of
    the process group (default: the whole world); ``inst_parallel`` ranks
    cooperate on each bag's instance axis, the rest form the data axis.
    With no process group and ``n_devices`` 1, a world of one is made
    here."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size() if n_devices is None else n_devices
    take_devices(n, device_type)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a mesh of {n} devices needs a process group of {n} ranks: "
                f"start them with torchrun --nproc_per_node {n}, or run the "
                f"train_wsi / train_mil CLIs, which start their workers "
                f"themselves")
        init_distributed(device_type=device_type, world_of_one=True)
    want = backend_for(device_type)
    if dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()}; a "
                         f"{device_type} mesh needs {want}")
    if inst_parallel is None:
        inst_parallel = default_inst_parallel(n)
    if inst_parallel < 1 or n % inst_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"inst_parallel={inst_parallel}")
    return init_device_mesh(device_type, (n // inst_parallel, inst_parallel),
                            mesh_dim_names=(DATA_AXIS, INST_AXIS))


def make_hybrid_mesh(ici_shape: Tuple[int, int], dcn_data: int = 1,
                     device_type: str = "cuda"):
    """A ``(data, inst)`` mesh over ``dcn_data`` nodes of ``ici_shape``
    devices each, whose ``inst`` groups never cross a node: ``inst`` is the
    innermost dimension, and a launcher numbers the ranks of one node
    consecutively, so each ``inst`` group lies inside one node's
    ``LOCAL_WORLD_SIZE`` ranks. Only the gradient sums cross nodes."""
    dp, sp = ici_shape
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if local % sp:
        raise ValueError(f"inst groups of {sp} would cross a node of "
                         f"{local} local ranks")
    return make_mesh(dcn_data * dp * sp, inst_parallel=sp,
                     device_type=device_type)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device_type: str = "cuda", world_of_one: bool = False
                     ) -> None:
    """Join or form the default process group.

    * Already initialised: benign, nothing happens.
    * A bare call: under a launcher (``WORLD_SIZE`` in the environment)
      joins its group through ``env://``; with no cluster it is a no-op,
      or, with ``world_of_one``, makes a single-process group over a
      ``file://`` store in a temporary directory.
    * An explicitly described cluster (``coordinator_address`` as
      ``host:port`` or a URL, ``num_processes``, ``process_id``) that
      fails to form raises: swallowing the error would silently turn an
      intended multi-process run into independent single-process ones.

    On ``cuda`` the process binds ``cuda:LOCAL_RANK`` first."""
    explicit = (coordinator_address, num_processes, process_id)
    launched = "WORLD_SIZE" in os.environ
    if dist.is_initialized() or not (
            any(a is not None for a in explicit) or launched or world_of_one):
        return
    backend = backend_for(device_type)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("describe the whole cluster: "
                             "coordinator_address, num_processes and "
                             "process_id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        _bind(device_type, process_id)
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif launched:
        _bind(device_type, int(os.environ.get("RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        _bind(device_type, 0)
        store = os.path.join(tempfile.mkdtemp(prefix="tpumil_torch_dist_"),
                             "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=1, rank=0)


def _bind(device_type: str, rank_: int) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank_)))


def needs_workers(n: int) -> bool:
    """True when a run of ``n`` devices has to start its own workers: more
    than one device, and neither a process group nor a launcher."""
    return n > 1 and not dist.is_initialized() \
        and "WORLD_SIZE" not in os.environ


def launch(fn: Callable, nprocs: int, args: Sequence = (),
           device_type: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``nprocs`` local worker processes joined into
    one process group over a ``file://`` store (rank r binds ``cuda:r`` on
    ``cuda``), saying so on stdout. ``fn`` must be importable by the
    spawned workers. An error in any worker stops the others and is raised
    here."""
    import torch.multiprocessing as mp

    take_devices(nprocs, device_type)
    print(f"starting {nprocs} workers on {device_type}", flush=True)
    tmp = tempfile.mkdtemp(prefix="tpumil_torch_dist_")
    try:
        mp.spawn(_worker, args=(nprocs, f"file://{os.path.join(tmp, 'store')}",
                                device_type, fn, tuple(args)),
                 nprocs=nprocs, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _worker(rank_: int, nprocs: int, init_method: str, device_type: str,
            fn: Callable, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank_)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    if "OMP_NUM_THREADS" not in os.environ:
        # the host's cores split between the workers, not each worker
        # spinning a thread on every core
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    init_distributed(init_method, nprocs, rank_, device_type=device_type)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()
