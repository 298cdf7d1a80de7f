"""Shared-memory array cache (port of seevcn_tpu/utils/shm_cache.py, host
numpy, copied: the same segment names and header, so an array written by
one package attaches in the other; reference SharedArray data plane:
common_utils.sa_create:255-259, waymo_dataset.py:34-37,77-105,
database_sampler.py:77-92 — `shm://` caches of point clouds and the gt
database shared across dataloader worker processes).

Built on multiprocessing.shared_memory: each array is one named segment
with a small header (dtype, ndim, shape) so attaching needs only the name.
Names mirror the reference's `shm://tag` convention with the prefix
stripped.
"""
from __future__ import annotations

import atexit
import hashlib
import struct
from multiprocessing import shared_memory

import numpy as np

_HEADER_FMT = "<16sB7q"          # dtype str (16 bytes), ndim, up to 7 dims
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_OWNED: dict[str, shared_memory.SharedMemory] = {}
# every handle we hand views out of must stay alive: SharedMemory.__del__
# unmaps the buffer and any numpy view into it would segfault
_ATTACHED: list = []


def _seg_name(name: str) -> str:
    name = name.removeprefix("shm://")
    # segment names have tight length limits on some platforms; hash long ones
    if len(name) > 24:
        return "sv_" + hashlib.md5(name.encode()).hexdigest()[:20]
    return "sv_" + name


def sa_create(name: str, arr: np.ndarray) -> np.ndarray:
    """Create (or replace) a named shared array holding ``arr``'s data.
    Returns a view backed by the shared segment."""
    arr = np.ascontiguousarray(arr)
    assert arr.ndim <= 7, "sa_create supports up to 7 dims"
    seg = _seg_name(name)
    try:
        old = shared_memory.SharedMemory(name=seg)
        old.close()
        old.unlink()
    except FileNotFoundError:
        pass
    shm = shared_memory.SharedMemory(name=seg, create=True,
                                     size=_HEADER_SIZE + max(arr.nbytes, 1))
    dims = list(arr.shape) + [0] * (7 - arr.ndim)
    shm.buf[:_HEADER_SIZE] = struct.pack(
        _HEADER_FMT, str(arr.dtype).encode().ljust(16), arr.ndim, *dims)
    view = np.ndarray(arr.shape, dtype=arr.dtype,
                      buffer=shm.buf[_HEADER_SIZE:_HEADER_SIZE + arr.nbytes])
    view[...] = arr
    _OWNED[seg] = shm
    return view


def sa_attach(name: str) -> np.ndarray:
    """Attach to an existing shared array by name. Raises FileNotFoundError
    if absent (callers use that to fall back to disk, like the reference)."""
    seg = _seg_name(name)
    shm = shared_memory.SharedMemory(name=seg)
    dt_raw, ndim, *dims = struct.unpack(_HEADER_FMT,
                                        bytes(shm.buf[:_HEADER_SIZE]))
    dtype = np.dtype(dt_raw.decode().strip())
    shape = tuple(dims[:ndim])
    nbytes = int(np.prod(shape)) * dtype.itemsize if ndim else dtype.itemsize
    view = np.ndarray(shape, dtype=dtype,
                      buffer=shm.buf[_HEADER_SIZE:_HEADER_SIZE + nbytes])
    _ATTACHED.append(shm)         # keep the handle so the buffer stays mapped
    return view


def sa_exists(name: str) -> bool:
    try:
        shm = shared_memory.SharedMemory(name=_seg_name(name))
        shm.close()
        return True
    except FileNotFoundError:
        return False


def sa_delete(name: str) -> None:
    seg = _seg_name(name)
    shm = _OWNED.pop(seg, None)
    try:
        shm = shm or shared_memory.SharedMemory(name=seg)
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


@atexit.register
def _cleanup():
    for seg, shm in list(_OWNED.items()):
        try:
            shm.close()
            shm.unlink()
        except Exception:
            pass
    _OWNED.clear()
