"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled for Hopper
(`sm_90a`) at first use into `build_dir()`: `build/kernels/` of the checkout
when the package sits in one, else the per-user cache
`~/.cache/mrclip_tpu_torch/kernels` (an installed package), under a file
name that carries the hash of the source, the headers it includes and the
flags, so an edited source or header rebuilds and an unchanged one
loads the library already built.
Nothing here runs at import time: the CPU tests import every module on a
host with no `nvcc`. Different sources build in parallel when loaded from
several threads (`load_libraries`); one source builds once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["ARCH_FLAGS", "CSRC", "BUILD_DIR", "build_dir", "nvcc_command", "source_key",
           "load_library", "load_libraries", "build_info"]

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"


def build_dir(package: Path = PACKAGE) -> Path:
    """Where the kernels of the package at `package` build: `build/kernels/`
    of the checkout when the package sits in one (a `pyproject.toml` beside
    it), else the per-user cache `~/.cache/mrclip_tpu_torch/kernels`."""
    if (package.parent / "pyproject.toml").is_file():
        return package.parent / "build" / "kernels"
    return Path.home() / ".cache" / "mrclip_tpu_torch" / "kernels"


BUILD_DIR = build_dir()
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)

_lock = threading.Lock()  # guards the dicts below
_name_locks: dict[str, threading.Lock] = {}  # one build of each source at a time
_libs: dict[str, ctypes.CDLL] = {}
_info: dict[str, dict] = {}


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc call that turns one `.cu` into a shared library.
    `-Xptxas -v` puts registers, shared memory and spills in the build log."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), str(src),
    ]


def _headers(src: Path) -> list[str]:
    """The headers beside `src` that it includes by quoted name, directly
    or through another such header, sorted."""
    seen: set[str] = set()
    todo = [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            if name not in seen:
                seen.add(name)
                todo.append(src.parent / name)
    return sorted(seen)


def source_key(src: Path) -> str:
    """Hash of the source, the headers of `csrc/` it includes by quoted
    name (and those include), and the nvcc flags: an edit to any of them
    rebuilds."""
    data = src.read_bytes() + b"".join((src.parent / h).read_bytes() for h in _headers(src))
    flags = " ".join(nvcc_command(src, Path("out"))).encode()
    return hashlib.sha256(data + flags).hexdigest()[:16]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if no build of this exact source exists, then
    load it. Raises with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_key(src)}.so"
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(str(out))
        if lib is not None:
            return lib
        info = {"path": str(out), "seconds": 0.0, "log": "(built earlier)"}
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(
                nvcc_command(src, tmp, _find_nvcc()), capture_output=True, text=True
            )
            info["seconds"] = time.perf_counter() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {src}:\n{info['log']}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(out))
        with _lock:
            _libs[str(out)] = lib
            _info[name] = info
    return lib


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """`load_library` for several sources at once, one nvcc each, all
    started together."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))


def build_info(name: str) -> dict:
    """Path, build seconds and nvcc log of the last `load_library(name)`."""
    return dict(_info[name])
