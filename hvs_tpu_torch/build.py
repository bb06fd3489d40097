"""Builds the package's CUDA kernels with nvcc at first use and loads them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, loaded with ``ctypes``. The library lands in ``_build/`` beside
this file (listed in ``.gitignore``), under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and never mistaken for
an old build. Importing this module builds nothing and needs no ``nvcc``.

    python -m hvs_tpu_torch.build

builds every source ahead of use (a container image's build step, so that
its runtime needs no ``nvcc`` and no write access to the package), prints
each library's path and build seconds, and exits non-zero if ``nvcc`` is
missing or a build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}  # wall time of each build made in this process


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the package's CUDA kernels are built from source at first use"
    )


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns each name's library path and
    records each build's wall time in ``build_seconds``; the compiler's
    report (registers, shared memory, spills) goes to ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        build_seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}, see {BUILD_DIR / (name + '.log')})")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def sources() -> List[str]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    argparse.ArgumentParser(description="Build every CUDA kernel of the package").parse_args(argv)
    names = sources()
    t0 = time.perf_counter()
    try:
        paths = build(names)
    except RuntimeError as e:
        print(f"build failed: {e}", file=sys.stderr)
        return 1
    for name in names:
        print(json.dumps({"source": str(CSRC_DIR / f"{name}.cu"), "library": str(paths[name]),
                          "build_s": build_seconds.get(name, 0.0)}))
    print(json.dumps({"built": len(build_seconds), "current": len(names) - len(build_seconds),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
