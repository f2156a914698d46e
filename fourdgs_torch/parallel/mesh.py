"""A mesh of ranks for multi-device mapping: a single controller over
`torch.distributed`, in the manner of a JAX device mesh.

The caller's process is rank 0. `make_mesh(n)` starts n - 1 worker
processes (the `spawn` start method), each bound to its device; every
rank joins one process group, rendezvous through a `FileStore` in a new
temporary directory (no fixed port, so meshes of several processes on one
machine never collide). The backend follows from the placement and is
printed: NCCL when every rank has a card of its own, gloo when ranks share
a card (NCCL refuses two ranks on one GPU) or run on the CPU.

`Mesh.run(fn, *args)` is the one way work reaches the workers: `fn` is a
function of this package, called on every rank as `fn(comm, *args)` (SPMD,
like the body of a `shard_map`). Host values in `args` go to the workers
through a pipe; tensors, at any depth of tuples, lists and dicts, go by
`broadcast` over the group, onto each rank's device. Rank 0 returns its
own result. Each worker reports a checksum of its result and the kernel
launches it made; `run` raises if a worker's result is not bit for bit
rank 0's (`fn` must leave every rank the same replicated state) and adds
the launches to `launches` (rank -> kernel -> number of views -> count).
`seconds` splits the last call's time on the host's clock: sending the
arguments, each rank's `fn` and checksum, and rank 0's wait for the
workers after its own part.

Workers make no decision of their own and keep nothing between calls.
A worker that fails sends its traceback and exits, which fails rank 0's
next collective at once; a dead worker does the same. Every collective
has the group's timeout, and `run` then raises with what the workers
said, after closing the mesh. `close()` (or leaving the `with` block)
stops every worker: asked first, then killed.
"""

from __future__ import annotations

import datetime
import hashlib
import importlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from fourdgs_torch.parallel.comm import Comm

DEFAULT_TIMEOUT_S = 300.0   # of every collective, and of a worker's answer


def placement(n: int, devices=None) -> list[torch.device]:
    """The devices of the n ranks: `devices` as given, else cuda:0 ...
    cuda:n-1, which must exist (no card is shared unless asked)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices given for a mesh of {n}")
        return [torch.device("cuda", 0) if d == torch.device("cuda") else d for d in devs]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"a mesh of {n} devices needs {n} CUDA devices, {have} found; "
                           "pass devices= to place ranks on a shared card or the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices: list[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and len(set(cuda)) == len(cuda):
        return "nccl"
    return "gloo"


def _group(store_path: str, rank: int, size: int, backend: str, timeout_s: float):
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.FileStore(store_path, size)
    store.set_timeout(timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, timeout)


class _Leaf:
    """Where a tensor stood in a call's arguments: its index among the
    call's tensors, shape and dtype."""

    def __init__(self, index: int, shape, dtype):
        self.index, self.shape, self.dtype = index, tuple(shape), dtype


def _strip(obj, tensors: list):
    """`obj` with every tensor replaced by a _Leaf (the tensors appended to
    `tensors` in order)."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return _Leaf(len(tensors) - 1, obj.shape, obj.dtype)
    if isinstance(obj, tuple):
        items = [_strip(x, tensors) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, list):
        return [_strip(x, tensors) for x in obj]
    if isinstance(obj, dict):
        return {k: _strip(v, tensors) for k, v in obj.items()}
    return obj


def _fill(obj, tensors: list):
    """The inverse of `_strip`."""
    if isinstance(obj, _Leaf):
        return tensors[obj.index]
    if isinstance(obj, tuple):
        items = [_fill(x, tensors) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, list):
        return [_fill(x, tensors) for x in obj]
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    return obj


def checksum(obj) -> str:
    """A digest of every tensor's bytes (and every other leaf's repr) in
    `obj`: equal results give equal digests, bit for bit."""
    h = hashlib.blake2b(digest_size=16)
    tensors: list = []
    skeleton = _strip(obj, tensors)
    h.update(repr(skeleton.__class__).encode())
    for t in tensors:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    _hash_host(h, skeleton)
    return h.hexdigest()


def _hash_host(h, obj):
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _hash_host(h, x)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            h.update(str(k).encode())
            _hash_host(h, obj[k])
    elif isinstance(obj, np.ndarray):
        h.update(obj.tobytes())
    elif not isinstance(obj, _Leaf):
        h.update(repr(obj).encode())


def _kernel_counters():
    from fourdgs_torch.ops.rasterize import kernels

    return {"composite_fwd": kernels.composite_fwd.launches_by_views,
            "composite_bwd": kernels.composite_bwd.launches_by_views}


def serve(rank: int, size: int, device: str, store_path: str, backend: str,
          timeout_s: float, threads: int, conn):
    """A worker's life: bind the device, join the group, then run each
    call rank 0 sends until it says stop or goes away."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        conn.send(("hello", os.getpid()))
        comm = Comm(_group(store_path, rank, size, backend, timeout_s), rank, size, dev)
        counters = _kernel_counters()
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            if msg[0] == "close":
                conn.send(("closed", sorted(m for m in sys.modules
                                            if m.split(".")[0] in ("jax", "fourdgs"))))
                return
            _, module, name, skeleton, specs = msg
            fn = getattr(importlib.import_module(module), name)
            tensors = [comm.broadcast(torch.empty(shape, dtype=dtype, device=dev))
                       for shape, dtype in specs]
            for c in counters.values():
                c.clear()
            t0 = time.perf_counter()
            out = fn(comm, *_fill(skeleton, tensors))
            comm.sync()
            t1 = time.perf_counter()
            digest = checksum(out)
            conn.send(("done", {"checksum": digest, "fn_s": t1 - t0,
                                "checksum_s": time.perf_counter() - t1,
                                "launches": {k: dict(c) for k, c in counters.items()}}))
    except BaseException:  # noqa: BLE001 -- reported to rank 0, then the worker ends
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)


class MeshError(RuntimeError):
    """A worker failed, died or diverged; the mesh is closed."""


class Mesh:
    """n ranks on `devices`, rank 0 in this process. See the module
    docstring; made by `make_mesh`."""

    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self.size = len(devices)
        self.backend = backend_for(devices)
        self.timeout_s = timeout_s = DEFAULT_TIMEOUT_S
        self.launches: dict[int, dict[str, dict[int, int]]] = {}
        self.calls = 0
        self.checksums: list[str] = []   # each rank's result digest of the last call
        # the last call's seconds on the host's clock: sending its arguments
        # (pipe and broadcasts), each rank's `fn` (device work included) and
        # checksum, and rank 0's wait for the workers' answers after its own
        self.seconds: dict = {}
        self.imported: list[list[str]] = []   # per worker at close: its jax/fourdgs modules
        self.closed = False
        self._tmp = tempfile.mkdtemp(prefix="fourdgs-mesh-")
        store_path = os.path.join(self._tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        self._procs, self._conns = [], []
        try:
            for r in range(1, self.size):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=serve, daemon=True, name=f"fourdgs-mesh-rank{r}",
                                args=(r, self.size, str(devices[r]), store_path, self.backend,
                                      timeout_s, torch.get_num_threads(), child))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            for r, conn in enumerate(self._conns, start=1):
                self._expect(r, conn, "hello")
            self.comm = Comm(_group(store_path, 0, self.size, self.backend, timeout_s), 0,
                             self.size, devices[0])
        except BaseException:
            self.close()
            raise
        print(f"[mesh] {self.size} ranks on {', '.join(str(d) for d in devices)} over "
              f"{self.backend}", flush=True)

    @property
    def pids(self) -> list[int]:
        """The workers' process ids (ranks 1 ... n-1)."""
        return [p.pid for p in self._procs]

    def _expect(self, rank: int, conn, kind: str):
        """The next message of worker `rank`, which must be of `kind`;
        raises MeshError if the worker reports an error, dies or says
        nothing within the timeout."""
        proc = self._procs[rank - 1]
        waited = 0.0
        while not conn.poll(0.2):
            waited += 0.2
            if not proc.is_alive():
                raise MeshError(f"mesh rank {rank} died (exit code {proc.exitcode})")
            if waited > self.timeout_s:
                raise MeshError(f"mesh rank {rank} sent nothing in {self.timeout_s:.0f} s")
        try:
            got, payload = conn.recv()
        except EOFError as e:
            raise MeshError(f"mesh rank {rank} closed its pipe") from e
        if got == "error":
            raise MeshError(f"mesh rank {rank} failed:\n{payload}")
        if got != kind:
            raise MeshError(f"mesh rank {rank} sent {got!r}, expected {kind!r}")
        return payload

    def _worker_errors(self) -> str:
        """What the workers said after a failure (a short wait for each)."""
        said = []
        for r, conn in enumerate(self._conns, start=1):
            try:
                if conn.poll(2.0):
                    kind, payload = conn.recv()
                    if kind == "error":
                        said.append(f"rank {r}:\n{payload}")
            except (EOFError, OSError):
                pass
            if not self._procs[r - 1].is_alive():
                said.append(f"rank {r} exited with code {self._procs[r - 1].exitcode}")
        return "\n".join(said)

    def run(self, fn, *args):
        """`fn(comm, *args)` on every rank; rank 0's result. See the
        module docstring."""
        if self.closed:
            raise MeshError("the mesh is closed")
        module = fn.__module__
        if not module.startswith("fourdgs_torch."):
            raise ValueError(f"{module}.{fn.__name__}: a mesh runs functions of fourdgs_torch only")
        tensors: list = []
        skeleton = _strip(args, tensors)
        tensors = [t.to(self.devices[0]) for t in tensors]
        specs = [(t.shape, t.dtype) for t in tensors]
        try:
            t0 = time.perf_counter()
            for conn in self._conns:
                conn.send(("call", module, fn.__name__, skeleton, specs))
            for t in tensors:
                self.comm.broadcast(t)
            t1 = time.perf_counter()
            out = fn(self.comm, *_fill(skeleton, tensors))
            self.comm.sync()
            t2 = time.perf_counter()
            self.checksums = [checksum(out)]
            t3 = time.perf_counter()
            secs = {"send": t1 - t0, "fn": [t2 - t1], "checksum": [t3 - t2]}
            for r, conn in enumerate(self._conns, start=1):
                rep = self._expect(r, conn, "done")
                self.checksums.append(rep["checksum"])
                secs["fn"].append(rep["fn_s"])
                secs["checksum"].append(rep["checksum_s"])
                self._add_launches(r, rep["launches"])
            secs["wait"] = time.perf_counter() - t3
            self.seconds = secs
            if len(set(self.checksums)) > 1:
                raise MeshError(f"the ranks ended {fn.__name__} in different states: "
                                f"{self.checksums}")
            self.calls += 1
        except MeshError:
            self.close()
            raise
        except Exception as e:
            said = self._worker_errors()
            self.close()
            raise MeshError(f"{fn.__name__} failed on the mesh: {e}"
                            + (f"\n{said}" if said else "")) from e
        return out

    def _add_launches(self, rank: int, launches: dict):
        mine = self.launches.setdefault(rank, {})
        for kernel, by_views in launches.items():
            acc = mine.setdefault(kernel, {})
            for v, n in by_views.items():
                acc[v] = acc.get(v, 0) + n

    def close(self):
        """Stop every worker (asked, then killed after a few seconds) and
        remove the rendezvous directory. `imported` then lists, per worker
        that answered, the modules of `jax` and `fourdgs` it had imported."""
        if self.closed:
            return
        self.closed = True
        imported = self.imported
        for r, (conn, p) in enumerate(zip(self._conns, self._procs), start=1):
            try:
                if p.is_alive():
                    conn.send(("close",))
                    if conn.poll(5.0):
                        kind, payload = conn.recv()
                        if kind == "closed":
                            imported.append(payload)
            except (EOFError, OSError):
                pass
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        self.comm = None
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc):
        self.close()


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """A mesh of `n_devices` ranks (see the module docstring). `devices`
    places them (default cuda:0 ... cuda:n-1, which must exist);
    `["cuda:0", "cuda:0"]` shares one card, `["cpu"] * n` runs on the
    CPU."""
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    return Mesh(placement(n_devices, devices))
