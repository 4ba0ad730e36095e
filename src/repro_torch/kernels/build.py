"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects are linked into one shared
library with a plain C interface.  The library lands in ``build/kernels/`` at
the repository root under a name keyed on a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads the existing file.  If
``nvcc`` fails, the build raises with its stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types; each returns an int (cudaGetLastError()
# after a launch, 0 from repro_weighted_agg_geometry) unless RESTYPES says
# otherwise.
SIGNATURES = {
    "repro_label_hist": [_P, _P, _P, _LL, _LL] + [_I] * 4 + [_LL, _LL, _I, _P],
    "repro_weighted_agg_f32": [_P, _I, _LL, _I, _P, _I, _LL, _P, _LL, _P],
    "repro_weighted_agg_bf16": [_P, _I, _LL, _I, _P, _I, _LL, _P, _LL, _P],
    "repro_weighted_agg_geometry": [_P, _P, _P],
    "repro_flash_attention_f32": [_P] * 5 + [_I] * 7 + [_P],
    "repro_flash_attention_bf16": [_P] * 5 + [_I] * 7 + [_P],
    "repro_flash_attention_f32_bwd": [_P] * 10 + [_I] * 7 + [_P],
    "repro_flash_attention_bf16_bwd": [_P] * 10 + [_I] * 7 + [_P],
    "repro_ssd_scan": [_P] * 8 + [_I] * 7 + [_P],
    "repro_ssd_scan_scratch_bytes": [_I] * 4,
    "repro_ssd_scan_bwd": [_P] * 13 + [_I] * 7 + [_P],
    "repro_ssd_scan_bwd_scratch_bytes": [_I] * 6,
    "repro_flash_attention_bwd_scratch_bytes": [_I] * 4,
}
RESTYPES = {"repro_ssd_scan_scratch_bytes": _LL,   # bytes of scratch
            "repro_ssd_scan_bwd_scratch_bytes": _LL,
            "repro_flash_attention_bwd_scratch_bytes": _LL}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): on PATH or in
    /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found on PATH or in /usr/local/cuda/bin; "
                       f"the CUDA kernels cannot be built or inspected")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return its
    path.  The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside it as ``<library>.log``."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{source_digest()}.so"
    if lib.exists():
        return lib
    nvcc = cuda_tool()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log = []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {proc.returncode}):\n{err}{out}")
            log.append(f"== {src.name}\n{err}{out}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *(str(o) for _, o, _ in jobs),
             "-o", str(staged)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stderr}{link.stdout}")
        Path(str(staged) + ".log").write_text("".join(log))
        os.replace(str(staged) + ".log", str(lib) + ".log")
        os.replace(staged, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
