"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library lives
under ``build/repro_torch/<hash of the sources>/`` at the repository root
(git-ignored), so an edited source rebuilds and an unchanged one loads the
library it built before.  A missing ``nvcc`` or a failed build raises: the
port never carries on with a kernel's plain version on the card.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero result.  The library links ``libcuda`` for the TMA descriptor
encoder ``cuTensorMapEncodeTiled``.  ptxas reports each
kernel's registers, shared memory and spills; the report is kept beside the
library as ``build.log`` (:func:`ptxas_report`).

:func:`plan_library` builds the attention split rules (``csrc/attn_plan.h``,
which the CUDA sources include) with the host C++ compiler into a second
small library, so that the wrappers, and the CPU tests without ``nvcc``,
read the rules the CUDA entry points apply.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hash_partition.cu", "join_probe.cu", "segment_reduce.cu", "flash_attention.cu",
           "flash_attention_bwd.cu")
HEADERS = ("wgmma.cuh", "attn_plan.h")  # included by the sources; hashed with them
# the attention key-split rule (attn_plan.h) for the wrappers: a host-only
# library, built by the host C++ compiler (plan_library)
PLAN_SOURCE = "attn_plan.cc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LOG_NAME = "build.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float

# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "rt_hash_row_buckets": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I64, _U32, _U32, _I, _P, _P, _P, _P, _P,
    ),
    "rt_hash_partition": (_P, _I64, _U32, _I, _P, _P, _P),
    "rt_probe_sorted": (_P, _I64, _P, _I64, _P, _P, _P, _I64, _P),
    "rt_segment_sum_i32": (_P, _P, _I64, _I64, _P, _P),
    "rt_segment_sum_f32": (_P, _P, _I64, _I64, _P, _P),
    "rt_flash_attention": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _F32, _P, _P, _P, _I, _I,
        _I, _I, _P, _I64, _I, _P,
    ),
    "rt_flash_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F32,
        _I, _I, _P,
    ),
}
PLAN_SIGNATURES = {
    "rt_flash_fwd_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "rt_flash_tiled_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "rt_flash_attention_bwd_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                    _P),
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link them; returns the .so path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed, logs = [], []
        for name, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        staged = Path(tmp) / lib.name
        cuda_root = Path(nvcc).resolve().parents[1]
        stubs = [f"-L{d}" for d in (cuda_root / "lib64" / "stubs",
                                    cuda_root / "targets" / "x86_64-linux" / "lib" / "stubs")
                 if d.is_dir()]
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged), *stubs, "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
        (out_dir / LOG_NAME).write_text("".join(logs))
        os.replace(staged, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def ptxas_report(pattern: str) -> dict[str, dict[str, int]]:
    """ptxas's report for each built kernel whose (mangled) name contains
    ``pattern``: registers, static shared memory, stack, spill stores and
    loads.  Dynamic shared memory is set at launch and not reported."""
    text = (build().parent / LOG_NAME).read_text()
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        for key, rx in (("stack_bytes", r"(\d+) bytes stack frame"),
                        ("spill_store_bytes", r"(\d+) bytes spill stores"),
                        ("spill_load_bytes", r"(\d+) bytes spill loads"),
                        ("registers", r"Used (\d+) registers"),
                        ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(rx, line)
            if m:
                out[name][key] = int(m.group(1))
        if "Used" in line and "registers" in line:
            name = None
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def plan_library() -> ctypes.CDLL:
    """The attention key-split rule (``csrc/attn_plan.cc`` over
    ``attn_plan.h``, the header the CUDA entry points decide with), built on
    first call by the host C++ compiler into ``build/repro_torch/plan-<hash>/``
    (no CUDA needed: the CPU tests read the plan too)."""
    h = hashlib.sha256()
    for name in (PLAN_SOURCE, "attn_plan.h"):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / f"plan-{h.hexdigest()[:16]}"
    lib = out_dir / "libattn_plan.so"
    if not lib.is_file():
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (c++ / g++): the attention plan cannot "
                               "be built")
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            staged = Path(tmp) / lib.name
            done = subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                                   str(CSRC / PLAN_SOURCE), "-o", str(staged)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {PLAN_SOURCE} (exit {done.returncode}):\n"
                                   f"{done.stdout}")
            os.replace(staged, lib)  # atomic: a concurrent loader sees all or nothing
    plan = ctypes.CDLL(str(lib))
    for name, argtypes in PLAN_SIGNATURES.items():
        fn = getattr(plan, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return plan


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {rc}")


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    return dev
