"""The memory-mapped tile store, for tensors (``onet_tpu/data/tilestore.py``).

``save_store`` / ``load_store`` persist dicts of tensors through the C++
store ``native/tilestore.cpp`` (unchanged, shared with the JAX package, so
a store written by one package reads in the other): open is O(1), no
unpickling, and a read is a view of the mapping. The library is built at
first use with ``g++`` into ``onet_tpu_torch/_build/``, named by a hash of
the source and flags, as ``ops/_build.py`` builds the CUDA sources;
nothing is written beside the source. Without a C++ toolchain the store
falls back to an ``.npz`` sibling, as the JAX package's does.

dtype ids: 0 float32, 1 uint16, 2 int32, 3 uint8, 4 int64, 5 bfloat16
(written through an int16 view: the store moves bytes); any other dtype is
stored as float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.ops._build import BUILD

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "tilestore.cpp")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_DTYPES = {0: torch.float32, 1: torch.uint16, 2: torch.int32, 3: torch.uint8,
           4: torch.int64, 5: torch.bfloat16}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}

_lib = None
_LOCK = threading.Lock()


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD, f"libtilestore-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> bool:
    """Compile the store with the host's C++ compiler; False without
    one."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return False
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{cxx} {_SRC} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out = _lib_path()
        if not os.path.exists(out) and not _build(out):
            return None
        lib = ctypes.CDLL(out)
        lib.ts_writer_open.restype = ctypes.c_void_p
        lib.ts_writer_open.argtypes = [ctypes.c_char_p]
        lib.ts_writer_add.restype = ctypes.c_int
        lib.ts_writer_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint64]
        lib.ts_writer_close.restype = ctypes.c_int
        lib.ts_writer_close.argtypes = [ctypes.c_void_p]
        lib.ts_open.restype = ctypes.c_void_p
        lib.ts_open.argtypes = [ctypes.c_char_p]
        lib.ts_num_entries.restype = ctypes.c_int
        lib.ts_num_entries.argtypes = [ctypes.c_void_p]
        lib.ts_entry.restype = ctypes.c_void_p
        lib.ts_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
        lib.ts_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def _host(arr) -> torch.Tensor:
    """A contiguous CPU tensor in a store dtype (others become float32)."""
    t = torch.as_tensor(arr).detach()
    if t.dtype not in _DTYPE_IDS:
        t = t.to(torch.float32)
    return t.cpu().contiguous()


def save_store(path: str, arrays: Dict[str, torch.Tensor]) -> str:
    """Write a dict of tensors (on any device; numpy arrays too). Returns
    the path written: an ``.npz`` sibling where no C++ toolchain is
    present (that fallback takes no bfloat16)."""
    lib = _load()
    if lib is None:
        alt = path + ".npz"
        host = {k: _host(v) for k, v in arrays.items()}
        if any(t.dtype == torch.bfloat16 for t in host.values()):
            raise TypeError("the .npz fallback stores no bfloat16; build "
                            "the native store (a C++ compiler is needed)")
        np.savez(alt, **{k: t.numpy() for k, t in host.items()})
        return alt
    w = lib.ts_writer_open(path.encode())
    if not w:
        raise OSError(f"cannot open {path} for writing")
    try:
        for name, arr in arrays.items():
            t = _host(arr)
            dtype_id = _DTYPE_IDS[t.dtype]
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            shape = (ctypes.c_int64 * t.ndim)(*t.shape)
            rc = lib.ts_writer_add(
                w, name.encode(), dtype_id, shape, t.ndim,
                ctypes.c_void_p(t.data_ptr()), t.numel() * t.element_size())
            if rc != 0:
                raise OSError(f"tilestore write failed rc={rc} for {name}")
    finally:
        rc = lib.ts_writer_close(w)
    if rc != 0:
        raise OSError(f"tilestore close failed rc={rc}")
    return path


class _Mapping:
    """One open store; unmapped when the last view of it is gone."""

    def __init__(self, lib, handle):
        self.lib, self.handle = lib, handle

    def __del__(self):
        self.lib.ts_close(self.handle)


def load_store(path: str, *, copy: bool = True,
               device=None) -> Dict[str, torch.Tensor]:
    """Load a store into a dict of tensors on ``device`` (default: the
    card; raises without one). ``copy=False`` (with ``device="cpu"``)
    returns views of the mapping, which stays mapped while a view lives;
    ``copy=True`` copies each tensor once, from the mapping to
    ``device``."""
    dev = resolve_device(device)
    if not copy and dev.type != "cpu":
        raise ValueError("copy=False returns views of the host mapping: "
                         "pass device='cpu'")
    if path.endswith(".npz") or (not os.path.exists(path)
                                 and os.path.exists(path + ".npz")):
        p = path if path.endswith(".npz") else path + ".npz"
        with np.load(p) as z:
            return {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    lib = _load()
    if lib is None:
        raise OSError("native tilestore unavailable and no .npz fallback")
    handle = lib.ts_open(path.encode())
    if not handle:
        raise OSError(f"cannot open/validate tile store {path}")
    mapping = _Mapping(lib, handle)
    out = {}
    for i in range(lib.ts_num_entries(handle)):
        name = ctypes.create_string_buffer(64)
        dtype = ctypes.c_uint32()
        shape = (ctypes.c_int64 * 8)()
        ndim = ctypes.c_uint32()
        nbytes = ctypes.c_uint64()
        ptr = lib.ts_entry(handle, i, name, ctypes.byref(dtype), shape,
                           ctypes.byref(ndim), ctypes.byref(nbytes))
        if not ptr or dtype.value not in _DTYPES:
            raise OSError(f"corrupt entry {i} in {path}")
        shp = tuple(shape[j] for j in range(ndim.value))
        t_dtype = _DTYPES[dtype.value]
        if nbytes.value == 0:
            t = torch.empty(shp, dtype=t_dtype)
        else:
            buf = (ctypes.c_char * nbytes.value).from_address(ptr)
            buf.mapping = mapping          # the views keep the mapping
            t = torch.frombuffer(buf, dtype=t_dtype).reshape(shp)
        out[name.value.decode()] = (t if not copy else
                                    t.to(dev, copy=True))
    return out
