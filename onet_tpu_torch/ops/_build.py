"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, into ``onet_tpu_torch/_build/`` (listed in ``.gitignore``); the file
name carries a hash of the source and flags, so an edited source rebuilds.
``build_all`` starts one ``nvcc`` per source, all at once, and keeps each
one's output (with ``-Xptxas -v``: every kernel's registers and spills) in
``LOGS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
# nvcc's output of each source built by this process (ptxas: registers,
# shared memory and spills of every kernel)
LOGS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _target(name: str) -> tuple:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return src, os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile_cmd(name: str):
    src, out = _target(name)
    if os.path.exists(out):
        return None, out
    tmp = f"{out}.{os.getpid()}.tmp"
    return [_nvcc(), *FLAGS, "-o", tmp, src], out


def build_all() -> list:
    """Compile every source under ``csrc/`` in parallel (one ``nvcc``
    each) and return the library paths. Raises with the compiler's output
    when one fails."""
    os.makedirs(BUILD, exist_ok=True)
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    jobs = []
    for name in names:
        cmd, out = _compile_cmd(name)
        proc = None if cmd is None else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, cmd, out, proc))
    errors = []
    for name, cmd, out, proc in jobs:
        if proc is None:
            continue
        log = proc.communicate()[0].decode(errors="replace")
        LOGS[name] = log
        tmp = cmd[cmd.index("-o") + 1]
        if proc.returncode:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out for _, _, out, _ in jobs]


def on_cpu(x, op: str) -> bool:
    """The wrappers' dispatch: True for a CPU tensor (the plain version),
    False for a CUDA tensor (the kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on the CPU (plain) or CUDA (kernel), "
                         f"not {x.device}")
    return x.device.type == "cpu"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            _, out = _target(name)
            if not os.path.exists(out):
                build_all()
            _LIBS[name] = ctypes.CDLL(out)
        return _LIBS[name]
