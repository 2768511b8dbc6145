"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``; no PyTorch header is compiled, so a build takes seconds.  The
libraries link the CUDA driver (``-lcuda``) for the tensor maps of TMA
loads.  They go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of every source and the flags, so a change
to any source rebuilds and an unchanged tree reuses the last build.
:func:`build_all` also builds another source directory into another build
directory, with the same flags (``benchmarks/bench_torch_attention_ab.py``
builds a parent commit's sources that way).

Nothing is built at import: the first launch builds what it needs, and
:func:`build_all` builds every kernel at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_attention", "paged_attention", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-lcuda",)           # after the source: cuTensorMapEncodeTiled

# name -> loaded library; a library is loaded once per process
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, csrc: Path = CSRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / f"{name}-{_digest(csrc)}.so"


def build_all(names: Sequence[str] = KERNELS, csrc: Path = CSRC,
              build_dir: Path = BUILD_DIR) -> Dict[str, Path]:
    """Compile every library in ``names`` from ``csrc`` into ``build_dir``
    that is not built yet, one ``nvcc`` per source, all running at once.
    Raises with the compiler's output if any build fails.  The ``ptxas``
    report (registers, shared memory, spills per kernel) is kept beside
    each library as ``.log``."""
    csrc, build_dir = Path(csrc), Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, csrc, build_dir) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu"),
               *LINK_FLAGS]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LIBS[name] = lib
    return lib
