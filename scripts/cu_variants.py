"""Variants of a kernel source, each the checkout's file with a few pieces
of text replaced, built into libraries of their own: the shared part of
``scripts/torch_*_variants.py``, which time and check such variants
against the checkout's kernels on one GPU.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path


def patched(src: str, pairs) -> str:
    """``src`` with every occurrence of each ``old`` of ``pairs`` replaced by
    its ``new``; raises if an ``old`` is not in it (the source moved on)."""
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"{old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build_variants(build, sources: dict, out_dir: Path, entry: str) -> dict:
    """Compile each of ``sources`` (name -> CUDA source text) with the
    build's flags into ``out_dir/<name>.so``, all ``nvcc`` runs at once;
    returns name -> (library with the argtypes of the entry points whose
    names start with ``entry``, ``nvcc``'s ``-Xptxas -v`` output)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [build.cuda_tool(), *build.FLAGS, "-shared", str(cu), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES.items():
            if fn.startswith(entry):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = build.RESTYPES.get(fn,
                                                             ctypes.c_int)
        built[name] = (lib, err + out)
    return built


def resources(log: str, kernel: str) -> dict:
    """Registers and spill bytes (stores and loads) of each kernel whose
    mangled name matches ``kernel`` (a regex whose group 1 is its name and
    group 2 its first template argument) in ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            short = re.search(kernel, m.group(1))
            name = f"{short.group(1)}<{short.group(2)}>" if short else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = (int(m.group(1))
                                                       + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out
