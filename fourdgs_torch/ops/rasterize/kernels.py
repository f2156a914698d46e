"""Build, load and launch the hand-written CUDA compositor kernels.

The sources in `csrc/` are compiled with nvcc for sm_90a into shared
libraries with a plain C interface, at first use, under a file lock, into
`fourdgs_torch/_build/` (git-ignored); a library is named by a hash of its
sources and flags, so an edited source is rebuilt. They are loaded with
ctypes: every pointer and the stream go as `c_void_p`, every C function
returns `cudaGetLastError()`, and the launches raise when it is not 0.
`build` and `load` also take another directory laid out like `csrc/`
(an earlier commit's sources), which `compositor_ab.py` times against it.

Importing this module needs neither CUDA nor nvcc. Each wrapper counts its
launches per number of views in a dict (`composite_fwd.launches_by_views`,
`composite_bwd.launches_by_views`); `fwd_into` and `bwd_into`, which
launch into outputs the caller allocated, count nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from fourdgs_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = {"composite_fwd": "composite_fwd.cu", "composite_bwd": "composite_bwd.cu"}
HEADERS = ("composite_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the forward must round like its plain version
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NOUT = 5      # per-pixel outputs: r, g, b, depth, T_final
NPIX = 256    # pixels of a 16x16 tile
NF = 10       # fields of a Gaussian row

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "composite_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "composite_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}
_fns: dict = {}   # (source directory, kernel name) -> its C launch function


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        h.update((Path(csrc) / fname).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(SOURCES), csrc: Path = CSRC) -> dict[str, str]:
    """Compile the named kernels of `csrc` that are not built yet, one nvcc
    process per source, all started together. Returns each new build's
    ptxas report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: dict[str, str] = {}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not library_path(n, csrc).exists()]
        procs = {}
        for n in todo:
            tmp = library_path(n, csrc).with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc) / SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {Path(csrc) / SOURCES[n]}:\n{log}")
            os.replace(tmp, library_path(n, csrc))
            reports[n] = log
    return reports


def load(name: str, csrc: Path = CSRC):
    """The C launch function of kernel `name` built from `csrc`, built
    first if need be."""
    key = (str(csrc), name)
    fn = _fns.get(key)
    if fn is None:
        path = library_path(name, csrc)
        if not path.exists():
            build((name,), csrc)
        fn = getattr(ctypes.CDLL(str(path)), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


def _check_inputs(fields, pair_gid, tile_start, tile_count, tiles_per_view):
    dev = fields.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA compositor needs CUDA tensors, got {dev}")
    _check(fields, "fields", torch.float32, dev)
    for t, what in ((pair_gid, "pair_gid"), (tile_start, "tile_start"),
                    (tile_count, "tile_count")):
        _check(t, what, torch.int32, dev)
    v, _, nf = fields.shape
    if nf != NF or tile_start.shape != tile_count.shape:
        raise ValueError("fields must be (V, N+1, 10) and the tile ranges alike")
    if tile_start.shape[0] != v * tiles_per_view:
        raise ValueError("tile ranges must cover V * tiles_per_view tiles")


def fwd_into(fn, fields, pair_gid, tile_start, tile_count, *, tiles_per_view, tx_n,
             width, height, out, n_contrib, n_touched):
    """Launch the forward C function `fn` (from `load`) into `out`,
    `n_contrib` and `n_touched`, which the caller allocated and, for
    n_touched, zeroed. Checks no shapes; counts nothing."""
    dev = fields.device
    with torch.cuda.device(dev):
        rc = fn(_ptr(fields), _ptr(pair_gid), _ptr(tile_start), _ptr(tile_count),
                tile_start.shape[0], tiles_per_view, tx_n, fields.shape[1], width, height,
                _ptr(out), _ptr(n_contrib), _ptr(n_touched),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {rc}")


def bwd_into(fn, fields, pair_gid, tile_start, tile_count, out, n_contrib, grad_out, *,
             tiles_per_view, tx_n, dfields):
    """Launch the backward C function `fn` (from `load`) into `dfields`,
    which the caller allocated and zeroed. Checks no shapes; counts
    nothing."""
    dev = fields.device
    with torch.cuda.device(dev):
        rc = fn(_ptr(fields), _ptr(pair_gid), _ptr(tile_start), _ptr(tile_count),
                tile_start.shape[0], tiles_per_view, tx_n, fields.shape[1],
                _ptr(out), _ptr(n_contrib), _ptr(grad_out), _ptr(dfields),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"composite_bwd launch failed: cudaError {rc}")


def composite_fwd(fields, pair_gid, tile_start, tile_count, *, tiles_per_view,
                  tx_n, width, height):
    """Launch the forward kernel. Returns (out (V*T, 5, 256) float32,
    n_contrib (V*T, 256) int32, n_touched (V, N+1) int32)."""
    _check_inputs(fields, pair_gid, tile_start, tile_count, tiles_per_view)
    v, n1, _ = fields.shape
    vt = tile_start.shape[0]
    dev = fields.device
    out = torch.empty((vt, NOUT, NPIX), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((vt, NPIX), dtype=torch.int32, device=dev)
    n_touched = torch.zeros((v, n1), dtype=torch.int32, device=dev)
    fwd_into(load("composite_fwd"), fields, pair_gid, tile_start, tile_count,
             tiles_per_view=tiles_per_view, tx_n=tx_n, width=width, height=height,
             out=out, n_contrib=n_contrib, n_touched=n_touched)
    _count(composite_fwd, v)
    return out, n_contrib, n_touched


def composite_bwd(fields, pair_gid, tile_start, tile_count, out, n_contrib,
                  grad_out, *, tiles_per_view, tx_n):
    """Launch the backward kernel. Returns dfields (V, N+1, 10) float32."""
    _check_inputs(fields, pair_gid, tile_start, tile_count, tiles_per_view)
    dev = fields.device
    vt = tile_start.shape[0]
    _check(out, "out", torch.float32, dev)
    _check(grad_out, "grad_out", torch.float32, dev)
    _check(n_contrib, "n_contrib", torch.int32, dev)
    if out.shape != (vt, NOUT, NPIX) or grad_out.shape != out.shape:
        raise ValueError("out and grad_out must be (V*T, 5, 256)")
    dfields = torch.zeros_like(fields)
    bwd_into(load("composite_bwd"), fields, pair_gid, tile_start, tile_count, out,
             n_contrib, grad_out, tiles_per_view=tiles_per_view, tx_n=tx_n, dfields=dfields)
    _count(composite_bwd, fields.shape[0])
    return dfields


def _count(wrapper, views: int):
    wrapper.launches_by_views[views] = wrapper.launches_by_views.get(views, 0) + 1


composite_fwd.launches_by_views = trace.register("composite_fwd.launches_by_views", {})
composite_bwd.launches_by_views = trace.register("composite_bwd.launches_by_views", {})
