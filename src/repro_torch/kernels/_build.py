"""Build and load the hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`.  The build
happens at first use, into ``build/repro_torch_kernels/`` at the repository
root (listed in ``.gitignore``); a library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and its flags, so an edited
source or header is rebuilt.  :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("maxmin", "horizon", "scan", "attention", "attention_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false where the kernel must round each product and sum as its plain
# version does (bit-equal results); the attention kernels are held to a
# tolerance instead and keep fused multiply-adds.
SOURCE_FLAGS = {"maxmin": ("-fmad=false",), "horizon": ("-fmad=false",),
                "scan": ("-fmad=false",), "attention": (),
                "attention_wgmma": ()}


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS[name]


_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA kernels cannot be built")
    return str(path)


def _lib_path(name: str) -> pathlib.Path:
    # the shared headers go into every source's hash
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every source in ``names`` that has no current library, all
    ``nvcc`` processes at once.  Returns the wall seconds of each build
    (0.0 for a library that was already current); the compiler's register
    and shared-memory report goes to ``<lib>.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler output saved by the build of ``csrc/<name>.cu``."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
