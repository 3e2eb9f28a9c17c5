"""The native (C++/OpenMP) neighbor search and slab partitioner, via ctypes.

The port's own copies of the FPIS search (``src/neighbor.cpp``) and the
slab partitioner (``src/partition.cpp``) of the JAX package's
``distmlip_tpu/neighbors/src`` compile together, with g++ at first use
(never at import), into one shared library with a plain C handle API:

    g++ -O3 -march=native -fopenmp -fPIC -std=c++17 -shared
        -o build/host/native-<hash>.so neighbor.cpp partition.cpp

The library lands in ``build/host/`` at the repository root (listed in
``.gitignore``) under a name keyed by a hash of the sources, the flags and
what ``-march=native`` selects on this host, so a changed source, or a
checkout copied to another CPU, rebuilds. A first build takes a file lock
and writes a temp file that it renames into place, so processes and
threads building at once get one library. A failed build raises with
g++'s output: there is no quiet numpy fallback. The one numpy path is the
empty system (no atoms), which the JAX package routes the same way.

Output order: edges come out grouped by src (the center atom), each group
in the scan order of its linked cells, whatever the thread count; the
numpy search orders them otherwise. The edge sets are equal.

Threads resolve as the ``num_threads`` argument, then the environment's
``DISTMLIP_TPU_NUM_THREADS``, then ``DISTMLIP_NUM_THREADS``, then 0 (the
OpenMP default: all cores), as in the JAX package. The count holds for
the call only (``src/thread_count.h``: PyTorch shares the OpenMP runtime),
and a call on fewer than 512 atoms stays on the calling thread, whatever
the count: there a team's barriers cost far more than the work whenever
the cores are oversubscribed. The output never depends on the count.
ctypes releases the GIL for the call, so a search on a worker thread
overlaps the main thread's work.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from .python_ref import NeighborList, neighbor_list_numpy

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = ("neighbor.cpp", "partition.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "host")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_path = None


def library_path() -> str:
    """``build/host/native-<hash>.so``: the hash covers every file in
    ``src/``, the flags and the target ``-march=native`` resolves to on
    this host."""
    global _path
    if _path is None:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        for name in sorted(os.listdir(SRC_DIR)):  # the sources and their header
            with open(os.path.join(SRC_DIR, name), "rb") as f:
                digest.update(name.encode() + f.read())
        target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                                capture_output=True, text=True)
        if target.returncode != 0:
            raise RuntimeError("g++ -march=native -Q --help=target failed "
                               f"(exit {target.returncode}):\n{target.stderr}")
        digest.update(target.stdout.encode())
        _path = os.path.join(BUILD_DIR, f"native-{digest.hexdigest()[:16]}.so")
    return _path


def build() -> float:
    """Compile the library if it is missing; returns the wall seconds spent
    (0.0 when it was there). Raises with g++'s output on failure."""
    path = library_path()
    if os.path.exists(path):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with open(path[:-3] + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # built by another process meanwhile
                return time.perf_counter() - t0
            tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}.so"
            cmd = ["g++", *CXX_FLAGS, "-o", tmp,
                   *(os.path.join(SRC_DIR, name) for name in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the native neighbor library failed "
                                   f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, dbl = ctypes.c_int64, ctypes.c_double
    p_i64, p_dbl = ctypes.POINTER(i64), ctypes.POINTER(dbl)
    lib.dm_neighbor_build.restype = ctypes.c_void_p
    lib.dm_neighbor_build.argtypes = [i64, p_dbl, p_dbl, p_i64, dbl, dbl, dbl, ctypes.c_int]
    lib.dm_neighbor_num_edges.restype = i64
    lib.dm_neighbor_num_edges.argtypes = [ctypes.c_void_p]
    lib.dm_neighbor_copy.restype = None
    lib.dm_neighbor_copy.argtypes = [ctypes.c_void_p, p_i64, p_i64,
                                     ctypes.POINTER(ctypes.c_int32), p_dbl,
                                     ctypes.POINTER(ctypes.c_uint8), p_dbl, p_i64]
    lib.dm_neighbor_free.restype = None
    lib.dm_neighbor_free.argtypes = [ctypes.c_void_p]
    lib.dm_partition_build.restype = ctypes.c_void_p
    lib.dm_partition_build.argtypes = [i64, i64, p_i64, p_i64, p_dbl, p_dbl, i64,
                                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                       ctypes.c_int]
    lib.dm_partition_err.restype = ctypes.c_int
    lib.dm_partition_err.argtypes = [ctypes.c_void_p, p_i64]
    lib.dm_partition_sizes.restype = None
    lib.dm_partition_sizes.argtypes = [ctypes.c_void_p, i64, p_i64]
    lib.dm_partition_copy.restype = None
    lib.dm_partition_copy.argtypes = [ctypes.c_void_p, i64] + [p_i64] * 12
    lib.dm_partition_free.restype = None
    lib.dm_partition_free.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if missing (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _declare(ctypes.CDLL(library_path()))
        return _lib


def resolve_num_threads(num_threads: int | None = None) -> int:
    """The host-thread knob (0 = all cores): the argument, then
    ``DISTMLIP_TPU_NUM_THREADS``, then ``DISTMLIP_NUM_THREADS``, then 0."""
    if num_threads is not None:
        return int(num_threads)
    return int(os.environ.get("DISTMLIP_TPU_NUM_THREADS",
                              os.environ.get("DISTMLIP_NUM_THREADS", 0)))


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def neighbor_list(cart, lattice, pbc, r: float, bond_r: float = 0.0, tol: float = 1e-8,
                  num_threads: int | None = None) -> NeighborList:
    """Periodic neighbor search within ``r`` (bonds within ``bond_r``): the
    native FPIS of the module docstring, edges grouped by src."""
    if np.asarray(cart).shape[0] == 0:
        return neighbor_list_numpy(cart, lattice, pbc, r, bond_r, tol)
    lib = load()
    cart = np.ascontiguousarray(cart, dtype=np.float64)
    lattice = np.ascontiguousarray(lattice, dtype=np.float64)
    pbc_arr = np.ascontiguousarray(np.asarray(pbc, dtype=np.int64))
    n = cart.shape[0]
    handle = lib.dm_neighbor_build(
        n, _ptr(cart, ctypes.c_double), _ptr(lattice, ctypes.c_double),
        _ptr(pbc_arr, ctypes.c_int64), float(r), float(bond_r), float(tol),
        resolve_num_threads(num_threads))
    if not handle:
        raise ValueError(f"native neighbor search refused r={r} (it needs r > 0)")
    try:
        ne = lib.dm_neighbor_num_edges(handle)
        src = np.empty(ne, dtype=np.int64)
        dst = np.empty(ne, dtype=np.int64)
        offsets = np.empty((ne, 3), dtype=np.int32)
        distances = np.empty(ne, dtype=np.float64)
        bond_mask = np.empty(ne, dtype=np.uint8)
        wrapped = np.empty((n, 3), dtype=np.float64)
        shift = np.empty((n, 3), dtype=np.int64)
        lib.dm_neighbor_copy(
            handle, _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
            _ptr(offsets, ctypes.c_int32), _ptr(distances, ctypes.c_double),
            _ptr(bond_mask, ctypes.c_uint8), _ptr(wrapped, ctypes.c_double),
            _ptr(shift, ctypes.c_int64))
    finally:
        lib.dm_neighbor_free(handle)
    return NeighborList(src, dst, offsets, distances, bond_mask.astype(bool), wrapped, shift)


class MultiPeerNode(RuntimeError):
    """A border node reaches more than one other partition (the slab rule
    allows one); ``node`` is its global id."""

    def __init__(self, node: int):
        super().__init__(f"native partitioner: node {node} reaches multiple partitions; "
                         "slab decomposition requires border nodes to reach exactly one "
                         "peer. Reduce num_partitions.")
        self.node = node


def native_partition(src, dst, frac_axis, walls, num_partitions, bond_mask,
                     use_bond_graph, num_threads=None) -> list[dict]:
    """Run the native slab partitioner; per partition a dict of int64
    arrays: ``global_ids``, ``node_markers``, ``edge_ids``, ``src_local``,
    ``dst_local`` and with ``use_bond_graph`` ``bond_markers``,
    ``bond_global_edge``, ``line_src``, ``line_dst``, ``line_center``,
    ``bm_edge``, ``bm_bond`` (the numpy partitioner's layout). Raises
    ``MultiPeerNode`` where the numpy path raises ``PartitionError``."""
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    frac_axis = np.ascontiguousarray(frac_axis, dtype=np.float64)
    walls = np.ascontiguousarray(walls, dtype=np.float64)
    bm = np.ascontiguousarray(
        bond_mask if bond_mask is not None else np.zeros(len(src), bool), dtype=np.uint8)
    n, ne, P = len(frac_axis), len(src), int(num_partitions)
    if len(dst) != ne or len(bm) != ne or len(walls) != P - 1:
        raise ValueError("native_partition: src, dst and bond_mask must have one length, "
                         "walls num_partitions - 1")
    h = lib.dm_partition_build(
        n, ne, _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        _ptr(frac_axis, ctypes.c_double), _ptr(walls, ctypes.c_double),
        P, _ptr(bm, ctypes.c_uint8), int(bool(use_bond_graph)),
        resolve_num_threads(num_threads))
    try:
        err_node = ctypes.c_int64(-1)
        if lib.dm_partition_err(h, ctypes.byref(err_node)) != 0:
            raise MultiPeerNode(int(err_node.value))
        names = ["global_ids", "node_markers", "edge_ids", "src_local", "dst_local"]
        bond_names = ["bond_markers", "bond_global_edge", "line_src", "line_dst",
                      "line_center", "bm_edge", "bm_bond"]
        null = ctypes.POINTER(ctypes.c_int64)()
        out = []
        for p in range(P):
            sizes = np.zeros(5, dtype=np.int64)
            lib.dm_partition_sizes(h, p, _ptr(sizes, ctypes.c_int64))
            nn, nee, nb, nl, nm = map(int, sizes)
            lengths = dict(global_ids=nn, node_markers=2 * P + 2, edge_ids=nee,
                           src_local=nee, dst_local=nee, bond_markers=2 * P + 2,
                           bond_global_edge=nb, line_src=nl, line_dst=nl,
                           line_center=nl, bm_edge=nm, bm_bond=nm)
            d = {k: np.empty(lengths[k], np.int64)
                 for k in names + (bond_names if use_bond_graph else [])}
            args = [_ptr(d[k], ctypes.c_int64) if k in d else null
                    for k in names + bond_names]
            lib.dm_partition_copy(h, p, *args)
            out.append(d)
        return out
    finally:
        lib.dm_partition_free(h)
