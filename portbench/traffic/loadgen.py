"""The load generator of the serving cells: a child process that posts
``.npy`` uint8 bodies to ``/v1/embed`` on an open loop.

The parent starts it with the server's port and the pool of patches in
shared memory, then hands it jobs: a schedule (due times, sizes, pool
offsets) and the requests whose answers it must bring back. For each job
the child sends every request when it is due from a pool of client
threads (one HTTP/1.1 connection each), and times it from when it was due
to when its answer was read. It sends back, for every request, its
latency (None when it failed or timed out) and how late it was sent, and
the answers of the sampled ones. A job of None ends it. It imports numpy
and the standard library alone.
"""

from __future__ import annotations

import http.client
import io
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Dict, List

import numpy as np

TIMEOUT_S = 60.0


def _body(pool: np.ndarray, offset: int, n: int):
    """The .npy header and a view of ``n`` rows of the pool (no copy)."""
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, {
        "descr": np.lib.format.dtype_to_descr(pool.dtype),
        "fortran_order": False, "shape": (n,) + pool.shape[1:]})
    return head.getvalue(), memoryview(pool[offset:offset + n]).cast("B")


def run(port: int, shm_name: str, pool_shape, threads: int, jobs,
        results) -> None:
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        pool = np.ndarray(pool_shape, np.uint8, buffer=shm.buf)
        local = threading.local()
        with ThreadPoolExecutor(threads) as ex:
            while True:
                job = jobs.get()
                if job is None:
                    return
                results.put(_job(pool, port, local, ex, *job))
    finally:
        shm.close()


def _job(pool, port, local, ex, due, sizes, offsets, keep) -> dict:
    keep_set = set(int(k) for k in keep)
    lat: List = [None] * len(due)
    late = np.zeros(len(due))
    answers: Dict[int, np.ndarray] = {}

    def conn():
        if getattr(local, "c", None) is None:
            local.c = http.client.HTTPConnection("127.0.0.1", port,
                                                 timeout=TIMEOUT_S)
        return local.c

    def send(i: int, t_due: float) -> None:
        late[i] = time.perf_counter() - t_due
        head, payload = _body(pool, int(offsets[i]), int(sizes[i]))
        try:
            c = conn()
            c.request("POST", "/v1/embed", body=[head, payload],
                      headers={"Content-Length":
                               str(len(head) + payload.nbytes),
                               "Content-Type": "application/x-npy"})
            r = c.getresponse()
            data = r.read()
            if r.status != 200:
                return
            lat[i] = time.perf_counter() - t_due
            if i in keep_set:
                answers[i] = np.load(io.BytesIO(data))
        except (OSError, http.client.HTTPException):
            local.c = None

    t0 = time.perf_counter()
    futs = []
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futs.append(ex.submit(send, i, t0 + d))
    for f in futs:
        f.result()
    return {"latency_s": lat, "late_s": late.tolist(), "answers": answers,
            "elapsed_s": time.perf_counter() - t0}
