"""Build the CUDA sources under ``spock_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``build/spock_tpu_torch/
<name>-<hash>.so`` at the root of the checkout, and loaded with ``ctypes``.
The hash covers the sources and the flags, so an edited source is rebuilt.
The sources whose sweeps unroll into minutes of ``ptxas`` (``PARTS``) are
compiled in parts at once, one nvcc per part (by value type, ``-DSPOCK_PART=4``
for the float entries and ``8`` for the double ones, and for ``cp_sweep`` by
``-DSPOCK_DIRECTION``: the node kernel with a direction apart), and then
linked.
A build runs on first use, never on import; ``start`` begins builds ahead of
use.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spock_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
PARTS = {
    "cp_sweep": tuple((f"-DSPOCK_PART={t}", f"-DSPOCK_DIRECTION={d}")
                      for t in (4, 8) for d in (0, 1)),
    "sp_step": (("-DSPOCK_PART=4",), ("-DSPOCK_PART=8",)),
}

_LIBS: dict = {}
# name -> (seconds, nvcc output) of the builds this process ran
BUILD_LOG: dict = {}
# name -> Future of a build this process started
_BUILDS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    parts = [" ".join(f) for f in PARTS.get(src.stem, ())]
    h.update(" ".join([*NVCC_FLAGS, *parts]).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _run(cmds) -> tuple:
    """Run the commands at once; (return codes, outputs)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], logs


def _compile(nvcc: str, src: Path, out: Path) -> None:
    """Build ``out`` from ``src`` (its parts at once, then the link) and
    record the seconds and nvcc's output in BUILD_LOG."""
    t0 = time.perf_counter()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    parts = PARTS.get(src.stem)
    if parts is None:
        rcs, logs = _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           str(src)]])
    else:
        objs = [out.with_name(f"{out.stem}.{k}.{os.getpid()}.o")
                for k in range(len(parts))]
        rcs, logs = _run([[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o),
                           str(src)] for flags, o in zip(parts, objs)])
        if not any(rcs):
            rc, link = _run([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
            rcs, logs = rcs + rc, logs + link
        for o in objs:
            o.unlink(missing_ok=True)
    log = "\n".join(logs)
    if any(rcs):
        raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[src.stem] = (time.perf_counter() - t0, log)


def start(names=None) -> dict:
    """Start building every source (or those named in ``names``) that has
    no up-to-date library and no build under way, each in its own thread;
    returns {name: Future} of the builds under way or just started."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    futures = {}
    with _LOCK:
        for src in sorted(CSRC.glob("*.cu")):
            name = src.stem
            if names is not None and name not in names:
                continue
            fut = _BUILDS.get(name)
            if fut is None or (fut.done() and fut.exception() is not None):
                out = _target(src)
                if out.exists():
                    continue
                fut = concurrent.futures.Future()
                _BUILDS[name] = fut
                threading.Thread(target=_build_into, args=(fut, src, out),
                                 daemon=True).start()
            futures[name] = fut
    return futures


def _build_into(fut, src: Path, out: Path) -> None:
    try:
        _compile(_nvcc(), src, out)
    except Exception as exc:  # raised to whoever waits on the build
        fut.set_exception(exc)
    else:
        fut.set_result(out)


def build_all(names=None) -> None:
    """Build every source (or those named in ``names``) without an
    up-to-date library, one nvcc per source or part, all at once, and wait;
    raises with every failed build's output."""
    failed = []
    for fut in start(names).values():
        try:
            fut.result()
        except RuntimeError as exc:
            failed.append(str(exc))
    if failed:
        raise RuntimeError("\n".join(failed))


def wait() -> None:
    """Wait for every build this process started, failed ones too."""
    concurrent.futures.wait(list(_BUILDS.values()))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first (or its build
    under way waited for) if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(CSRC / f"{name}.cu")
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib
