"""Build and load the hand-written CUDA kernels, and count their launches.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded
with ``ctypes``.  No PyTorch header is compiled, so a build takes
seconds.  Libraries go to ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of their sources and flags:
an edited source rebuilds, an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for every one.

Nothing here runs at import: the CPU tests import every module of the
port, and only a launch on a CUDA tensor builds anything.

``LAUNCHES`` counts kernel launches by name.  Each wrapper launches
through ``launch``, which enters its tensors' device, and adds one right
after its kernel launched, and nowhere else, so a run can show that the
main path went through every kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# kernel library name -> its translation unit
SOURCES = {
    "spike_conv": "spike_conv.cu",
    "spike_conv_lif": "spike_conv_lif.cu",
    "spike_dwconv": "spike_dwconv.cu",
    "max_pool": "max_pool.cu",
    "spike_matmul": "spike_matmul.cu",
    "lif_scan": "lif_scan.cu",
    "norm_affine_lif": "norm_affine_lif.cu",
    "event_voxel": "event_voxel.cu",
    "demosaic": "demosaic.cu",
    "nlm": "nlm.cu",
    "isp_fused": "isp_fused.cu",
    "backbone_segment": "backbone_segment.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Path]:
    """Compile every (or the named) kernel library that is not built
    yet, one ``nvcc`` per source, all started together.  Raises with the
    compiler's output if any build fails.  Returns name -> library."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    nvcc = _nvcc() if todo else None
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    current build of ``name``; empty if it was built by another run."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signature) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use).
    ``signature`` is ``(symbol, argtypes)`` of one of its launch
    functions, set on that symbol's first use (a library may hold
    several); the function returns a ``cudaError_t`` as int."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    symbol, argtypes = signature
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise where grad mode is on and a tensor requires grad: a kernel
    called outside its op's autograd Function (or one with no backward)
    would return a result with no graph, dropping it silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward here; "
                           f"an input requires grad (call it under "
                           f"torch.no_grad(), or through its op in "
                           f"kernels/ops.py where it has one)")


def check_f32(name: str, *tensors) -> torch.device:
    """The one device of ``tensors``, after checking that each is float32,
    contiguous and on that device (a CPU or CUDA device), and, on a CUDA
    device, that none needs a gradient the kernel cannot give
    (``refuse_grad``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda":
        refuse_grad(name, *tensors)
    return dev


def stream_of(dev) -> int:
    """The raw handle of torch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise on a launch error; otherwise count the launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def launch(name: str, dev: torch.device, fn, *args,
           check=check_launch) -> None:
    """Every wrapper's one launch path: the C launch function ``fn`` of
    kernel ``name`` called with ``args`` and, last, ``dev``'s current
    stream, under ``torch.cuda.device(dev)``, then ``check(name, err)``
    (which raises on an error and counts the launch).  A launch through
    ``ctypes`` runs on the current CUDA device, not the tensors': without
    the guard a kernel called from another card's thread of work would
    launch on that card with ``dev``'s pointers."""
    with torch.cuda.device(dev):
        err = fn(*args, stream_of(dev))
    check(name, err)
