"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>.so`` through one nvcc call::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/lib<name>.so csrc/<name>.cu

Headers shared between sources are ``csrc/*.cuh``.  ``build_all`` starts
one nvcc per stale source, all at once, and waits for them; ptxas'
register/shared-memory report lands in ``build/<name>.log``.  A failed
build raises.  ``LAUNCHES`` counts kernel launches per kernel (per kernel
body where one library holds several, as K1's f32 and bf16 bodies, K4/K5
in ``topk_matmul.cu`` or K6's two in ``int8_matmul.cu``; K7,
``decode_attention``, counts its two launches a call under one key, K8,
``moe_experts``, its four, K9, ``rms_norm``, its one): every wrapper
launches through ``launch``, which counts them, nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
KERNELS = ("sdag_prefill", "bm25_scan_topk", "encoder_attention",
           "topk_matmul", "int8_matmul", "decode_attention", "moe_experts",
           "rms_norm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}
_SM_COUNT: Dict[object, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (persistent kernels
    launch one block per SM); asked of CUDA once per device."""
    n = _SM_COUNT.get(device)
    if n is None:
        import torch
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device] = n
    return n


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sdag_tpu_torch need the CUDA toolkit")
    return path


def _so_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """A library is stale when its source or any shared header is newer."""
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every stale kernel library in parallel; returns seconds per
    library built.  Raises RuntimeError with nvcc's output on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _so_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    times, errors = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD, f"{name}.log"), "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, _so_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_so_path(name))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def launch(lib: ctypes.CDLL, fn: str, *args, device, count_key=None,
           n: int = 1) -> None:
    """Call the launch function ``fn`` of ``lib`` (its argtypes set by the
    wrapper) on ``device``'s current stream: a tensor or None goes as its
    device pointer, any other argument as it is, the stream's handle
    last.  Raises on a CUDA error code, then adds ``n`` to
    ``LAUNCHES[count_key]`` (None: a prologue counted with its kernel)."""
    import torch
    rc = getattr(lib, fn)(*(
        ctypes.c_void_p(None if a is None else a.data_ptr())
        if a is None or isinstance(a, torch.Tensor) else a for a in args),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    check(lib, rc, fn)
    if count_key is not None:
        LAUNCHES[count_key] += n
