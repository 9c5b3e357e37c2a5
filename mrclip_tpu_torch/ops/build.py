"""Build the port's CUDA sources with nvcc, and its host C++ library with the
system C++ compiler, and load them through ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled for Hopper
(`sm_90a`) at first use into `build_dir()`: `build/kernels/` of the checkout
when the package sits in one, else the per-user cache
`~/.cache/mrclip_tpu_torch/kernels` (an installed package), under a file
name that carries the hash of the source, the headers it includes and the
flags, so an edited source or header rebuilds and an unchanged one
loads the library already built. `load_host_library` does the same for
host-only C++ (`native_src/*.cc`, the native data loader) with `c++` or
`g++`, zlib and pthreads, and no `-march=native`: a checkout copied to
another host must not load instructions that host lacks (FMA aside, see
`HOST_CXX_FLAGS`).
Nothing here runs at import time: the CPU tests import every module on a
host with no `nvcc`. Different sources build in parallel when loaded from
several threads (`load_libraries`); one source builds once, and a library
is written under a temporary name and renamed into place, so processes
building the same source at once each load a whole file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["ARCH_FLAGS", "CSRC", "NATIVE_SRC", "BUILD_DIR", "HOST_CXX_FLAGS", "build_dir",
           "nvcc_command", "cxx_command", "source_key", "load_library", "load_libraries",
           "load_host_library", "build_info"]

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NATIVE_SRC = PACKAGE / "native_src"


def build_dir(package: Path = PACKAGE) -> Path:
    """Where the kernels of the package at `package` build: `build/kernels/`
    of the checkout when the package sits in one (a `pyproject.toml` beside
    it), else the per-user cache `~/.cache/mrclip_tpu_torch/kernels`."""
    if (package.parent / "pyproject.toml").is_file():
        return package.parent / "build" / "kernels"
    return Path.home() / ".cache" / "mrclip_tpu_torch" / "kernels"


BUILD_DIR = build_dir()
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -mfma on x86-64: the fused multiply-adds that the JAX package's
# -march=native build contracts to, so both libraries give the same bytes
# (without it 6e-4 of the resized pixels differ by up to 2 levels); every
# x86 host of a Hopper card has FMA. Other ISAs (aarch64) have it in their
# base and contract by default.
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
                  *(("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ()))
HOST_LIBS = ("-lz", "-lpthread")

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


def _build_and_load(name: str, out: Path, command, tool: str) -> ctypes.CDLL:
    """Run `command(tmp_path)` unless `out` exists, rename the result to
    `out`, load it, and record its build info under `name`. Raises with the
    compiler's output when the build fails."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(str(out))
        if lib is not None:
            return lib
        info = {"path": str(out), "seconds": 0.0, "log": "(built earlier)"}
        if not out.is_file():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
            cmd = command(tmp)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            info["command"] = " ".join(cmd)
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{tool} failed on {name}:\n{info['log']}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(out))
        with _lock:
            _libs[str(out)] = lib
            _info[name] = info
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if no build of this exact source exists, then
    load it. Raises with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_key(src)}.so"
    return _build_and_load(name, out, lambda tmp: nvcc_command(src, tmp, _find_nvcc()), "nvcc")


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """`load_library` for several sources at once, one nvcc each, all
    started together."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))


def build_info(name: str) -> dict:
    """Path, build seconds, command and compiler log of the last
    `load_library(name)` or `load_host_library(name, ...)`."""
    return dict(_info[name])


def cxx_command(sources, out: Path, cxx: str = "c++") -> list[str]:
    """The C++ compiler call that turns host-only sources into one shared
    library linked against zlib and pthreads."""
    return [cxx, *HOST_CXX_FLAGS, *map(str, sources), *HOST_LIBS, "-o", str(out)]


def _find_cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) found on PATH; the host library of the "
                       "native data loader cannot be built")


def load_host_library(name: str, sources) -> ctypes.CDLL:
    """Compile the host-only C++ `sources` into `lib<name>-<hash>.so` if no
    build of exactly these sources and flags exists, then load it. Raises
    naming what is missing: the compiler, zlib's header or zlib itself."""
    sources = [Path(s) for s in sources]
    flags = " ".join(cxx_command([s.name for s in sources], Path("out"))).encode()
    key = hashlib.sha256(b"".join(s.read_bytes() for s in sources) + flags).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    try:
        return _build_and_load(name, out, lambda tmp: cxx_command(sources, tmp, _find_cxx()),
                               "the C++ compiler")
    except RuntimeError as e:
        msg = str(e)
        if "zlib.h" in msg:
            raise RuntimeError(f"zlib's header zlib.h is missing; {name} cannot be built:\n"
                               f"{msg}") from None
        if "-lz" in msg and "cannot find" in msg:
            raise RuntimeError(f"zlib (libz.so) is missing; {name} cannot be linked:\n"
                               f"{msg}") from None
        raise
