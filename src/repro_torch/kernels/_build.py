"""Builds the port's CUDA sources and binds them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``) into
``<repo>/build/repro_torch/lib<name>-<hash>.so`` at first use; the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds. All sources
compile at once, one ``nvcc`` each; a source listed in ``PARTS`` compiles
as that many parts at once (``-DREPRO_PART=i``, each instantiating a share
of its kernels), linked into its one library. No ``--use_fast_math``: the
quantizers need IEEE division. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("qmatmul", "flash_prefill", "paged_attn", "qdecode",
           "quantize_weights")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: sources built as parts, one ``nvcc -c`` each, in parallel: flash_prefill.cu
#: holds ~70 tile instantiations of three bodies (``REPRO_PART`` 0:
#: flash_tc and flash_mla, 1: flash_qtc, 2: flash_q4tc)
PARTS = {"flash_prefill": 3}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas registers / shared memory / spills) per source
BUILD_LOG: Dict[str, str] = {}

P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                           "with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> None:
    """Compile every source that has no current library, all in parallel."""
    with _LOCK:
        todo = [n for n in SOURCES if not _target(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        part_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = []                          # (source, output, process)
        for name in todo:
            src = str(CSRC / f"{name}.cu")
            tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
            if name in PARTS:
                cmds = [(tmp.with_suffix(f".{i}.o"),
                         [nvcc, *part_flags, f"-DREPRO_PART={i}", "-c"])
                        for i in range(PARTS[name])]
            else:
                cmds = [(tmp, [nvcc, *NVCC_FLAGS])]
            for out, cmd in cmds:
                procs.append((name, out, subprocess.Popen(
                    [*cmd, "-o", str(out), src], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        logs, outs, failed = {}, {}, set()
        for name, out, proc in procs:       # wait for all before raising
            logs[name] = logs.get(name, "") + proc.communicate()[0]
            outs.setdefault(name, []).append(out)
            if proc.returncode:
                failed.add(name)
        for name, files in outs.items():
            tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
            if name in PARTS:
                if name not in failed:      # one library of the parts
                    link = subprocess.run(
                        [nvcc, *NVCC_FLAGS[:2], "-shared", "-Xcompiler",
                         "-fPIC", "-o", str(tmp), *map(str, files)],
                        capture_output=True, text=True)
                    logs[name] += link.stdout + link.stderr
                    if link.returncode:
                        failed.add(name)
                for f in files:
                    f.unlink(missing_ok=True)
            if name not in failed:
                os.replace(tmp, _target(name))
        BUILD_LOG.update(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}.cu ---\n{BUILD_LOG[n]}" for n in failed))


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                lib.repro_error_string.argtypes = [I]
                lib.repro_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function with its signature declared (pointers and the stream
    as ``c_void_p`` so 64-bit addresses are never cut)."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        # restype first: a shard thread that sees argtypes set sees both
        fn.restype = I
        fn.argtypes = list(argtypes)
    return fn


def check(lib_name: str, rc: int, what: str) -> None:
    if rc:
        msg = library(lib_name).repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would need a gradient through a kernel that has
    no backward: its output would carry no ``grad_fn`` and cut the graph
    without a word. Called on the CUDA branch of every wrapper but
    ``flash_prefill``'s, which has one."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call "
                           "it under torch.no_grad() or on inputs that "
                           "require no grad")


_COUNT_LOCK = threading.Lock()


def count(fn, **by) -> None:
    """One launch of ``fn``'s kernel: ``fn.launches += 1`` and, for each
    ``attr=key``, ``fn.<attr>[key] += 1``, under one lock, so the counts
    stay exact when threads launch at once. A ``ShardGroup``'s shards take
    turns and never do; the lock is for callers outside one."""
    with _COUNT_LOCK:
        fn.launches += 1
        for attr, key in by.items():
            getattr(fn, attr)[key] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
