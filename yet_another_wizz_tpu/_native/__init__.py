"""ctypes bindings for the native tile-packing kernels.

Compiles ``tilepack.cpp`` on first use and exposes thin numpy wrappers.
The library is cached under ``build/`` next to the source, named by the
SHA-256 of the source, so only a library built from the current source
is ever loaded: a stale or foreign ``.so`` lying in the tree is ignored.
All consumers must degrade gracefully when no compiler is
available — ``NATIVE_ENABLED`` is False then and the numpy fallbacks in
:mod:`yet_another_wizz_tpu.ops.tiles` take over.

Set ``YAWT_DISABLE_NATIVE=1`` to force the numpy implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from yet_another_wizz_tpu.utils.misc import env_flag

__all__ = [
    "NATIVE_ENABLED",
    "assign_patches",
    "assign_patches_radec",
    "counting_argsort_ids",
    "encode_fixedpoint",
    "env_flag",
    "filter_tile_pairs",
    "gather_f64",
    "gather_i32",
    "gather_i32_to_f64",
    "gather_rows",
    "morton_codes",
    "pack_tiles",
    "patch_geometry",
    "radec_to_xyz",
    "sort_order",
    "tile_caps",
]

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).parent / "tilepack.cpp"


def library_path(source: Path | None = None) -> Path:
    """Where the library built from ``source``'s current content lives
    (default: the package's ``tilepack.cpp``)."""
    source = source or _SOURCE
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return source.parent / "build" / f"libtilepack-{digest}.so"


_lib = None
NATIVE_ENABLED = False


def _build_library(library: Path) -> bool:
    # -ffp-contract=off pins the no-FMA evaluation the numpy parity
    # tests rely on: gcc's default contracts a*b - c*d into FMA where the
    # ISA has it as baseline (aarch64), perturbing the tile-pair filter
    # bound by ~1 ulp vs numpy's two-op evaluation.
    # concurrent first uses (test workers) each build to a private name
    # and publish with an atomic rename
    staging = library.with_name(f"{library.stem}.{os.getpid()}.tmp")
    command = [
        "g++", "-O3", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC",
        str(_SOURCE), "-o", str(staging),
    ]
    try:
        library.parent.mkdir(exist_ok=True)
        subprocess.run(
            command, check=True, capture_output=True, timeout=120
        )
        os.replace(staging, library)
        return True
    except (OSError, subprocess.SubprocessError) as err:
        logger.warning("building native tilepack library failed: %s", err)
        return False


def _load() -> None:
    global _lib, NATIVE_ENABLED
    if env_flag("YAWT_DISABLE_NATIVE"):
        return
    try:
        library = library_path()
        if not library.exists() and not _build_library(library):
            return
        _lib = ctypes.CDLL(str(library))
    except OSError as err:
        logger.warning("loading native tilepack library failed: %s", err)
        return

    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    _lib.morton_codes.argtypes = [f64p, i64, ctypes.c_int32, i64p]
    _lib.assign_patches.argtypes = [f64p, i64, f64p, i64, i32p]
    _lib.pack_tiles.argtypes = [f64p, f64p, f64p, i64p, i64, i64, f32p]
    _lib.tile_center_sums.argtypes = [f64p, i64p, i64, i64, f64p]
    _lib.tile_max_chord.argtypes = [f64p, i64p, i64, i64, f64p, f64p]
    _lib.radec_to_xyz.argtypes = [f64p, f64p, i64, f64p]
    _lib.min_dist2_update.argtypes = [f64p, i64, f64p, f64p]
    _lib.interleave_columns.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, i64, i64, f64p
    ]
    _lib.interleave_columns.restype = ctypes.c_int
    _lib.patch_geometry.argtypes = [
        f64p, ctypes.c_void_p, i32p, i64, i64, f64p, f64p
    ]
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    _lib.encode_fixedpoint.argtypes = [
        f32p, f64p, i64, i64, ctypes.c_double, i32p, f32p, i8p
    ]
    _lib.filter_tile_pairs.argtypes = [
        i64p, i64p, i64p, i64p, i64,            # slot starts/sizes
        f64p, f64p, f64p, f64p,                 # caps 1 (+ cos/sin radii)
        f64p, f64p, f64p, f64p,                 # caps 2 (+ cos/sin radii)
        ctypes.c_double, ctypes.c_double,       # cutoff, cos(cutoff)
        ctypes.c_double, ctypes.c_int32,        # sin(cutoff), per_tile mode
        ctypes.c_void_p, ctypes.c_void_p,       # zmin1/zmax1 (optional)
        ctypes.c_void_p, ctypes.c_void_p,       # zmin2/zmax2 (optional)
        ctypes.c_void_p, ctypes.c_void_p,       # range_max + cos table
        ctypes.c_void_p, i64,                   # sin table (all optional)
        i64p,                                   # per-slot kept counts
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
    ]
    _lib.filter_tile_pairs.restype = i64
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    _lib.make_sort_keys.argtypes = [
        i32p, i32p, i64p, i64, ctypes.c_int32, ctypes.c_int32, u64p
    ]
    _lib.radix_argsort.argtypes = [u64p, i64, i64p]
    _lib.gather_f64.argtypes = [f64p, i64p, i64, i64, f64p]
    _lib.gather_i32.argtypes = [i32p, i64p, i64, i32p]
    _lib.gather_i32_to_f64.argtypes = [i32p, i64p, i64, f64p]
    _lib.radec_to_xyz_strided.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, i64, f64p
    ]
    _lib.assign_patches_radec.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, i64, f64p, i64, i32p
    ]
    _lib.counting_argsort_ids.argtypes = [i32p, i64, i64, i64p, i64p]
    _lib.gather_rows.argtypes = [
        ctypes.c_void_p, i64, i64p, i64, ctypes.c_void_p
    ]
    NATIVE_ENABLED = True


_load()


def morton_codes(xyz: np.ndarray, bits: int = 10) -> np.ndarray:
    """Native Morton codes (see ops.tiles for the numpy fallback)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    out = np.empty(len(xyz), dtype=np.int64)
    _lib.morton_codes(xyz, len(xyz), bits, out)
    return out


def pack_tiles(
    xyz: np.ndarray,
    weights: np.ndarray,
    zbins: np.ndarray,
    dest: np.ndarray,
    num_tiles: int,
    tile_size: int,
) -> np.ndarray:
    """Scatter points into the packed (num_tiles, 8, T) float32 layout."""
    lane_data = np.zeros((num_tiles, 8, tile_size), dtype=np.float32)
    _lib.pack_tiles(
        np.ascontiguousarray(xyz, np.float64),
        np.ascontiguousarray(weights, np.float64),
        np.ascontiguousarray(zbins, np.float64),
        np.ascontiguousarray(dest, np.int64),
        len(xyz),
        tile_size,
        lane_data,
    )
    return lane_data


def tile_caps(
    xyz: np.ndarray,
    dest: np.ndarray,
    num_tiles: int,
    tile_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile cap centers (unit vectors) and radii (chord distances)."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    dest = np.ascontiguousarray(dest, np.int64)
    sums = np.zeros((num_tiles, 3), dtype=np.float64)
    _lib.tile_center_sums(xyz, dest, len(xyz), tile_size, sums)
    norms = np.linalg.norm(sums, axis=1)
    centers = np.zeros((num_tiles, 3))
    centers[:, 0] = 1.0
    nonempty = norms > 0
    centers[nonempty] = sums[nonempty] / norms[nonempty, None]

    max_chord = np.zeros(num_tiles)
    _lib.tile_max_chord(
        xyz, dest, len(xyz), tile_size,
        np.ascontiguousarray(centers), max_chord,
    )
    return centers, max_chord


def encode_fixedpoint(
    lane_data: np.ndarray, tile_center: np.ndarray, scale_floor: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-point lane encoding (the upload hot path; see
    ops.tiles.encode_fixedpoint_lanes for the numpy fallback and the
    layout contract)."""
    num_tiles, _, tile_size = lane_data.shape
    packed = np.empty((num_tiles, 4, tile_size), dtype=np.int32)
    params = np.empty((num_tiles, 8), dtype=np.float32)
    zbins = np.empty((num_tiles, tile_size), dtype=np.int8)
    _lib.encode_fixedpoint(
        np.ascontiguousarray(lane_data, np.float32),
        np.ascontiguousarray(tile_center, np.float64),
        num_tiles,
        tile_size,
        scale_floor,
        packed,
        params,
        zbins,
    )
    return packed, params, zbins


def filter_tile_pairs(
    start1: np.ndarray,
    start2: np.ndarray,
    n1: np.ndarray,
    n2: np.ndarray,
    centers1: np.ndarray,
    radii1: np.ndarray,
    centers2: np.ndarray,
    radii2: np.ndarray,
    *,
    cutoff_angle: float = 0.0,
    per_tile: int = 0,
    zmin1: np.ndarray | None = None,
    zmax1: np.ndarray | None = None,
    zmin2: np.ndarray | None = None,
    zmax2: np.ndarray | None = None,
    range_max: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cap-pruned tile-pair enumeration over linked patch-pair slots (the
    build_tile_pairs hot loop; see ops/linkage.py for the numpy fallback
    and tilepack.cpp for the predicate contract). Two native passes: a
    sizing pass, then a fill pass into exactly-sized outputs — peak
    memory is the RESULT, never the candidate grid. All trig is
    precomputed HERE with numpy (per-tile cos/sin of the cap radii plus
    the theta table) so the kernel's cosine-form cap test sees the exact
    inputs the numpy fallback computes for itself."""
    num_slots = len(start1)
    radii1 = np.ascontiguousarray(radii1, np.float64)
    radii2 = np.ascontiguousarray(radii2, np.float64)
    args = [
        np.ascontiguousarray(start1, np.int64),
        np.ascontiguousarray(start2, np.int64),
        np.ascontiguousarray(n1, np.int64),
        np.ascontiguousarray(n2, np.int64),
        num_slots,
        np.ascontiguousarray(centers1, np.float64),
        radii1,
        np.cos(radii1),
        np.sin(radii1),
        np.ascontiguousarray(centers2, np.float64),
        radii2,
        np.cos(radii2),
        np.sin(radii2),
        float(cutoff_angle),
        float(np.cos(cutoff_angle)),
        float(np.sin(cutoff_angle)),
        int(per_tile),
    ]
    holders = []  # keep the contiguous copies alive across both calls

    def opt(arr, dtype):
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr, dtype)
        holders.append(arr)
        return arr.ctypes.data

    args += [
        opt(zmin1, np.int32), opt(zmax1, np.int32),
        opt(zmin2, np.int32), opt(zmax2, np.int32),
        opt(range_max, np.float64),
        opt(None if range_max is None else np.cos(range_max), np.float64),
        opt(None if range_max is None else np.sin(range_max), np.float64),
        0 if range_max is None else range_max.shape[1],
    ]
    slot_counts = np.empty(num_slots, dtype=np.int64)
    total = _lib.filter_tile_pairs(
        *args, slot_counts, None, None, None
    )
    tile1 = np.empty(total, dtype=np.int32)
    tile2 = np.empty(total, dtype=np.int32)
    slot = np.empty(total, dtype=np.int32)
    _lib.filter_tile_pairs(
        *args, slot_counts,
        tile1.ctypes.data, tile2.ctypes.data, slot.ctypes.data,
    )
    return tile1, tile2, slot


def sort_order(
    patch_ids: np.ndarray,
    zbins: np.ndarray | None,
    morton: np.ndarray,
    *,
    morton_bits: int = 30,
) -> np.ndarray:
    """Stable argsort by (patch, zbin, morton) — the tile-layout sort —
    as ONE parallel radix pass set over a composite uint64 key, replacing
    ``np.lexsort``'s three stable single-threaded argsorts. ``zbins=None``
    sorts by (patch, morton) only (the "spatial" layout)."""
    n = len(morton)
    patch_ids = np.ascontiguousarray(patch_ids, np.int32)
    morton = np.ascontiguousarray(morton, np.int64)
    keys = np.empty(n, dtype=np.uint64)
    if zbins is None:
        zb = np.zeros(n, dtype=np.int32)
        zbin_bits = 0
    else:
        zb = np.ascontiguousarray(zbins, np.int32)
        zbin_bits = 16
    _lib.make_sort_keys(patch_ids, zb, morton, n, zbin_bits,
                        morton_bits, keys)
    order = np.empty(n, dtype=np.int64)
    _lib.radix_argsort(keys, n, order)
    return order


def gather_f64(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order]`` for float64 arrays of shape (n,) or (n, k)."""
    src = np.ascontiguousarray(src, np.float64)
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty((len(order), *src.shape[1:]), dtype=np.float64)
    k = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    _lib.gather_f64(src, order, len(order), k, out)
    return out


def gather_i32(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order]`` for int32 arrays."""
    src = np.ascontiguousarray(src, np.int32)
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty(len(order), dtype=np.int32)
    _lib.gather_i32(src, order, len(order), out)
    return out


def gather_i32_to_f64(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order].astype(float64)`` for int32 arrays (fuses the
    gather with the dtype conversion the packed lane layout needs)."""
    src = np.ascontiguousarray(src, np.int32)
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty(len(order), dtype=np.float64)
    _lib.gather_i32_to_f64(src, order, len(order), out)
    return out


def assign_patches(xyz: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-center argmax assignment without score-matrix temporaries."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    centers = np.ascontiguousarray(centers, np.float64)
    out = np.empty(len(xyz), dtype=np.int32)
    _lib.assign_patches(xyz, len(xyz), centers, len(centers), out)
    return out


def _strided_f8(arr: np.ndarray) -> tuple[np.ndarray, int, int]:
    """``(array, data pointer, byte stride)`` for a 1-D float64 input.

    Float64 1-D views pass through WITHOUT copying whatever their stride
    (structured-array columns — the catalog chunk and patch-cache row
    layout — are exactly such views); anything else is converted once.
    The returned array must stay referenced for the pointer's lifetime.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.float64 or arr.ndim != 1:
        arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data, arr.strides[0]


def radec_to_xyz(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """Unit-sphere 3-vectors from (ra, dec) in radian (single write pass).

    Strided float64 inputs (structured-array columns) convert in place —
    no ascontiguousarray copies."""
    ra, ra_ptr, ra_stride = _strided_f8(ra)
    dec, dec_ptr, dec_stride = _strided_f8(dec)
    out = np.empty((len(ra), 3), dtype=np.float64)
    _lib.radec_to_xyz_strided(ra_ptr, ra_stride, dec_ptr, dec_stride,
                              len(ra), out)
    return out


def assign_patches_radec(
    ra: np.ndarray, dec: np.ndarray, centers: np.ndarray
) -> np.ndarray:
    """Nearest-center ids straight from (strided) ra/dec columns.

    Fuses ``radec_to_xyz`` + ``assign_patches`` with identical arithmetic
    (bit-identical ids) but no ``(n, 3)`` xyz temporary — the ingestion
    assignment's memory traffic drops to the two input columns."""
    ra, ra_ptr, ra_stride = _strided_f8(ra)
    dec, dec_ptr, dec_stride = _strided_f8(dec)
    centers = np.ascontiguousarray(centers, np.float64)
    out = np.empty(len(ra), dtype=np.int32)
    _lib.assign_patches_radec(ra_ptr, ra_stride, dec_ptr, dec_stride,
                              len(ra), centers, len(centers), out)
    return out


def counting_argsort_ids(
    ids: np.ndarray, num_ids: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stable argsort of small non-negative int ids + their histogram.

    Equals ``np.argsort(ids, kind="stable")`` with ``counts[d] ==
    np.count_nonzero(ids == d)`` returned for free (one parallel pass)."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    order = np.empty(len(ids), dtype=np.int64)
    counts = np.empty(num_ids, dtype=np.int64)
    _lib.counting_argsort_ids(ids, len(ids), num_ids, order, counts)
    return order, counts


def gather_rows(records: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``records[order]`` for a C-contiguous structured array."""
    assert records.flags["C_CONTIGUOUS"]
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(len(order), dtype=records.dtype)
    _lib.gather_rows(records.ctypes.data, records.dtype.itemsize, order,
                     len(order), out.ctypes.data)
    return out


def patch_geometry(
    xyz: np.ndarray,
    weights: np.ndarray | None,
    patch_ids: np.ndarray,
    num_patches: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-patch cap centers (weighted spherical means) and angular radii."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    ids = np.ascontiguousarray(patch_ids, dtype=np.int32)
    centers = np.empty((num_patches, 3), dtype=np.float64)
    radii = np.empty(num_patches, dtype=np.float64)
    w_ptr = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        w_ptr = weights.ctypes.data
    _lib.patch_geometry(
        xyz, w_ptr, ids, len(xyz), num_patches, centers, radii
    )
    return centers, radii


def min_dist2_update(
    xyz: np.ndarray, center: np.ndarray, min_d2: np.ndarray
) -> None:
    """In-place ``min_d2 = minimum(min_d2, |xyz - center|^2)`` (no
    temporaries; the numpy expression allocates three catalog-sized
    intermediates per call)."""
    _lib.min_dist2_update(
        xyz, len(xyz), np.ascontiguousarray(center, np.float64), min_d2
    )


def interleave_columns(columns, out: np.ndarray) -> int:
    """Interleave float64 column arrays into ``out`` (an (n, k) float64
    view of a record array) with a fused finite check. Returns the lowest
    index of any non-finite column in the ORDER THE COLUMNS ARE PASSED
    (the caller passes them in dtype field order, so the error message
    matches the numpy fallback's first-error when the values dict shares
    that order), or -1 on success."""
    ptrs = (ctypes.c_void_p * len(columns))(
        *(c.ctypes.data for c in columns)
    )
    stride = out.strides[0] // 8
    return _lib.interleave_columns(
        ptrs, len(columns), len(out), stride, out
    )
