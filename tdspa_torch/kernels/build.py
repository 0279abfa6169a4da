"""Build the CUDA kernels under ``tdspa_torch/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/tdspa_torch/lib<name>-<digest>.so`` at
the repository root (git-ignored). The digest covers the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: a kernel builds at its first use, or all
of them together (one ``nvcc`` each, in parallel) through ``build_all``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import tempfile
import time

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdspa_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Extra flags per source. --fmad=false keeps the LK kernel from fusing a
# product and a sum into one rounding, so its thresholded decisions see the
# values its plain version computes.
EXTRA_FLAGS = {"lk": ("--fmad=false",)}
KERNELS = ("attention", "vit_attention", "lk", "matcher")


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "tdspa_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns seconds of wall time per library built (0.0 for one already
    built). The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
