"""In-fold train state checkpoints (counterpart of
tpumil/io/native_ckpt.py's sharded train state), through ``torch.save``.

A state is a directory holding ``state.pt`` (a dict of tensors and
``state_dict``s: parameters, the Adam ``state_dict``, the best parameters)
and ``meta.json`` (counters, the best scores, the host RNG's
``bit_generator.state``). A save overwrites in place without ever leaving
no loadable copy: the new state goes to a sibling ``.inflight`` directory,
then two renames swap it in, and the previous state survives as ``.prev``
until the new one is in place; :func:`load_train_state` falls back to
``.prev`` when a crash came between the renames.

The state of a multi-device run is replicated on every rank:
:func:`save_sharded_train_state` writes it from rank 0 between two
barriers, and :func:`load_sharded_train_state` loads it on every rank, so
a state saved at one world size resumes at any other. The JAX package's
orbax states are not read.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import torch

STATE = "state.pt"
META = "meta.json"


def save_train_state(path: str, state: Any, *,
                     meta: Optional[dict] = None) -> None:
    path = os.path.abspath(path)
    inflight = path + ".inflight"
    prev = path + ".prev"
    shutil.rmtree(inflight, ignore_errors=True)
    os.makedirs(inflight)
    torch.save(state, os.path.join(inflight, STATE))
    with open(os.path.join(inflight, META), "w") as f:
        json.dump(meta or {}, f)
    # `prev` may be the ONLY loadable copy (an earlier save crashed between
    # its two renames, so `path` is missing): it is demoted over only while
    # `path` holds a complete generation, and removed only after the new
    # `path` is in place.
    if os.path.exists(path):
        shutil.rmtree(prev, ignore_errors=True)
        os.rename(path, prev)
    os.rename(inflight, path)
    shutil.rmtree(prev, ignore_errors=True)


def load_train_state(path: str, map_location=None) -> Tuple[Any, dict]:
    """``(state, meta)`` saved by :func:`save_train_state`; the ``.prev``
    generation when ``path`` itself is missing. The state is loaded with
    ``weights_only=True``: tensors and plain containers only."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".prev"):
        path = path + ".prev"
    state = torch.load(os.path.join(path, STATE), map_location=map_location,
                       weights_only=True)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    return state, meta


def save_sharded_train_state(path: str, state: Any, *,
                             meta: Optional[dict] = None) -> None:
    """:func:`save_train_state` from a process group (counterpart of the
    JAX package's ``save_sharded_train_state``): the state is replicated,
    so after a barrier rank 0 alone writes it, with the ``.inflight`` /
    ``.prev`` swap, and a second barrier holds every rank until it is in
    place. Without a process group it is :func:`save_train_state`."""
    from tpumil_torch.parallel.mesh import barrier, is_main

    barrier()
    if is_main():
        save_train_state(path, state, meta=meta)
    barrier()


def load_sharded_train_state(path: str, map_location=None
                             ) -> Tuple[Any, dict]:
    """:func:`load_train_state` on every rank, onto its own device
    (``map_location``), after a barrier: whatever world size saved the
    state, it loads on any other."""
    from tpumil_torch.parallel.mesh import barrier

    barrier()
    return load_train_state(path, map_location)
