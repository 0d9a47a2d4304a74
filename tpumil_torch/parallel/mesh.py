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
counterpart here: each rank holds its own tensors.

The embedding half (``--data_parallel N`` of the feature, inference and
serving CLIs): :class:`BatchShardedForward` is the counterpart of
``make_batch_sharded_jit``. JAX drives every device from one process; here
rank 0 feeds. It runs the caller unchanged (loaders, HTTP front, files)
and, for each batch, broadcasts a small header (operation, forward, dtype,
rows per rank, image shape), scatters B / N rows to every rank, embeds its
own rows and gathers every rank's outputs back in row order: three
collectives a batch, none of which waits on the host. Ranks 1..N-1 run only
:func:`follow` until rank 0 sends "stop" (:func:`lead` does both sides).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import weakref
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
                f"start them with torchrun --nproc_per_node {n}, or run a "
                f"CLI with --inst_shard / --data_parallel {n}, which starts "
                f"its workers itself")
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
        ctx = mp.spawn(_worker, args=(nprocs,
                                      f"file://{os.path.join(tmp, 'store')}",
                                      device_type, fn, tuple(args)),
                       nprocs=nprocs, join=False)
        try:
            while not ctx.join():
                pass
        except KeyboardInterrupt:
            # a signal to this process (a server's SIGTERM) goes on to rank
            # 0, which stops its followers itself; what still runs a minute
            # later is terminated too
            ctx.processes[0].terminate()
            for p in ctx.processes:
                p.join(60)
                if p.is_alive():
                    p.terminate()
            raise
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


def start_workers(main: Callable, argv: Sequence[str], n: int,
                  device_type: str) -> bool:
    """The CLIs' ``--data_parallel N``: with N > 1 and neither a process
    group nor a launcher, check the host (:func:`take_devices`, before any
    work), run ``main(argv)`` in N local workers and return True once they
    are done; else return False, and the caller runs as its rank."""
    if not needs_workers(n):
        return False
    take_devices(n, device_type)
    launch(main, n, (list(argv),), device_type)
    return True


# -- the embedding half: rank 0 feeds, every rank embeds its rows -----------

STOP, FORWARD, KEEPALIVE = 0, 1, 2
# input dtypes a header names, by code
_DTYPES = (torch.uint8, torch.float32)
# op, forward id, dtype code, rows per rank, H, W, C
HEADER = 7
# this process's sharded forwards by id, in creation order: every rank
# makes the same ones in the same order, so an id names one forward on
# every rank (weak: a finished caller's model is not kept alive here)
_forwards: list = []


def check_data_parallel(n: int, batch_size: int) -> None:
    """``--data_parallel N``'s refusals, before any worker starts: N < 0,
    and a batch that does not divide by N (JAX's ``data_parallel_mesh`` and
    ``make_batch_sharded_jit`` messages)."""
    if n < 0:
        raise ValueError(f"--data_parallel must be >= 0, got {n}")
    if n and batch_size % n:
        raise ValueError(f"batch_size {batch_size} must divide by the "
                         f"mesh's device count ({n}x1={n})")


def data_parallel_mesh(n: Optional[int], what: str = "extraction",
                       device_type: str = "cuda"):
    """A 1-wide-inst mesh over the N ranks of the process group, or None
    when N is 0/None (the single-device path); negative N raises."""
    if not n:
        return None
    if n < 0:
        raise ValueError(f"--data_parallel must be >= 0, got {n}")
    if is_main():
        print(f"data-parallel {what} over {n} devices", flush=True)
    return make_mesh(n, inst_parallel=1, device_type=device_type)


@contextlib.contextmanager
def data_parallel(n: Optional[int], what: str = "extraction",
                  device_type: str = "cuda"):
    """:func:`data_parallel_mesh` for the life of a block: joins a
    launcher's group, or, for N = 1 without one, makes a world of one and
    takes it down after the block."""
    made = False
    if n and not dist.is_initialized():
        made = n == 1 and "WORLD_SIZE" not in os.environ
        init_distributed(device_type=device_type, world_of_one=made)
    try:
        yield data_parallel_mesh(n, what, device_type)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def feed_collective(op: Callable, *args, **kwargs) -> None:
    """Every collective of the feed, counted, with the host seconds spent
    in the call (NCCL returns once the work is queued; gloo once it is
    done), in all and by collective."""
    t0 = time.perf_counter()
    op(*args, **kwargs)
    dt = time.perf_counter() - t0
    feed_collective.seconds += dt
    feed_collective.calls += 1
    by = feed_collective.by_op.setdefault(op.__name__, [0, 0.0])
    by[0] += 1
    by[1] += dt


feed_collective.calls = 0
feed_collective.seconds = 0.0
feed_collective.by_op = {}  # name -> [calls, seconds]


def _comm_device() -> torch.device:
    """Where the group's tensors live: the bound card for NCCL, the host
    for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _send_header(op: int, fid: int = 0, dtype=torch.uint8, rows: int = 0,
                 shape=(0, 0, 0)) -> None:
    h = torch.tensor([op, fid, _DTYPES.index(dtype), rows, *shape],
                     dtype=torch.int64)
    dev = _comm_device()
    if dev.type == "cuda":
        # pinned and non-blocking: a pageable copy would wait for the
        # batches already queued on the device
        h = h.pin_memory().to(dev, non_blocking=True)
    feed_collective(dist.broadcast, h, src=0)
    _send_header.last = time.monotonic()


_send_header.last = time.monotonic()


class BatchShardedForward:
    """``fwd`` (an embedder: ``[b, H, W, C]`` images -> a tuple of ``[b,
    w]`` outputs) with each batch's rows split over every rank of ``mesh``
    (the counterpart of ``make_batch_sharded_jit``): the batch must divide
    by the mesh's rank count, which ``batch_size`` is checked against.

    Called on rank 0 with a batch on its ``device``, it returns every
    output for the whole batch there, in row order; the other ranks serve
    the call from :func:`follow`. Each rank's rows go through ``fwd`` on
    its own device, so at world 1 the result is bitwise the unsharded
    one."""

    def __init__(self, mesh, batch_size: int, fwd: Callable,
                 device: torch.device):
        n = int(mesh.size())
        if batch_size % n:
            raise ValueError(
                f"batch_size {batch_size} must divide by the mesh's device "
                f"count ({'x'.join(map(str, mesh.shape))}={n})")
        if n != world_size():
            raise ValueError(f"a batch-sharded forward needs a mesh over the "
                             f"whole process group ({world_size()} ranks), "
                             f"got {n}")
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot feed a "
                             f"forward on {device}")
        self.n_shard = n
        self.fwd = fwd
        self.device = device
        self.id = len(_forwards)
        _forwards.append(weakref.ref(self))
        if device.type == "cuda" and n > 1:
            # the kernels build once, on rank 0, before any rank loads them
            # (N ranks would otherwise run nvcc N times over)
            if is_main():
                from tpumil_torch.utils import build

                build.build()
            barrier()

    def __call__(self, x: torch.Tensor):
        if x.ndim != 4 or x.shape[0] % self.n_shard:
            raise ValueError(f"expected [B, H, W, C] images with B a multiple "
                             f"of {self.n_shard}, got {tuple(x.shape)}")
        rows = x.shape[0] // self.n_shard
        if rows == 0:
            return self.fwd(x)
        _send_header(FORWARD, self.id, x.dtype, rows, x.shape[1:])
        local = torch.empty((rows, *x.shape[1:]), dtype=x.dtype,
                            device=self.device)
        feed_collective(dist.scatter, local,
                        list(x.contiguous().chunk(self.n_shard)), src=0)
        return self._gather(self.fwd(local))

    def _gather(self, outs):
        """Rank 0: every rank's outputs, in row order; elsewhere, this
        rank's sent to rank 0. The outputs travel as one f32 tensor and
        come back in their own dtypes (bf16 -> f32 -> bf16 is exact)."""
        outs = tuple(outs)
        packed = torch.cat([o.float() for o in outs], dim=1)
        if not is_main():
            feed_collective(dist.gather, packed, None, dst=0)
            return None
        buf = torch.empty((self.n_shard, *packed.shape), dtype=packed.dtype,
                          device=packed.device)
        feed_collective(dist.gather, packed, list(buf.unbind(0)), dst=0)
        parts = buf.flatten(0, 1).split([o.shape[1] for o in outs], dim=1)
        return tuple(p.to(o.dtype) for p, o in zip(parts, outs))


def follow() -> None:
    """Ranks 1..N-1: run rank 0's batches through this process's sharded
    forwards until rank 0 sends "stop"."""
    dev = _comm_device()
    with torch.inference_mode():
        while True:
            h = torch.empty(HEADER, dtype=torch.int64, device=dev)
            feed_collective(dist.broadcast, h, src=0)
            op, fid, code, rows, *shape = h.tolist()
            if op == STOP:
                break
            if op == KEEPALIVE:
                continue
            f = _forwards[fid]()
            local = torch.empty((rows, *shape), dtype=_DTYPES[code],
                                device=f.device)
            feed_collective(dist.scatter, local, None, src=0)
            f._gather(f.fwd(local))
    _forwards.clear()


def stop_followers() -> None:
    """Rank 0: send "stop" to every follower (once per feed)."""
    if _forwards and world_size() > 1:
        _send_header(STOP)
    _forwards.clear()


def keepalive(every_s: float) -> None:
    """Rank 0, between batches: a header that the followers skip, at most
    every ``every_s`` seconds, so that an idle feed never waits past the
    group's timeout on a follower."""
    if _forwards and world_size() > 1 \
            and time.monotonic() - _send_header.last >= every_s:
        _send_header(KEEPALIVE)


def lead(mesh, work: Callable):
    """``work()`` on rank 0, served by every other rank of ``mesh``: ranks
    1..N-1 follow until rank 0 stops them, which it does when ``work``
    returns or raises. Without a mesh, ``work()`` alone. Returns what
    ``work`` returns on rank 0, None elsewhere."""
    if mesh is None:
        return work()
    if not is_main():
        follow()
        return None
    try:
        return work()
    finally:
        stop_followers()
