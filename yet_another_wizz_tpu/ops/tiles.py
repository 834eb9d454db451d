"""Device-friendly catalog layout: spatially sorted, padded point tiles.

The reference implementation builds one scipy kd-tree per (patch, redshift
bin) (/root/reference/src/yaw/catalog/trees.py:365-429). Accelerators want
static shapes and dense math instead, so a catalog becomes a
:class:`TileSet`:

- points are sorted by (patch id, Morton code of the unit-sphere position),
  so that consecutive points are spatial neighbours;
- each patch is zero-padded to a multiple of the tile size ``T``;
- every ``T`` consecutive points form a *tile* with a bounding cap
  (center + opening angle) used to prune distant tile pairs — the tile-level
  analogue of the kd-tree's node bounds;
- per-point data is packed into a single float32 array of shape
  ``(num_tiles, 8, T)`` (channels x points, points contiguous along the
  last dimension): unit-sphere xyz split into (hi, lo) float32 pairs for
  small-angle precision, the pair weight, and the redshift-bin index.

Weights of padding points are zero, so they never contribute to counts.
The packing hot path (Morton codes, the scatter into the packed layout,
tile caps) uses the native C++ kernels from
:mod:`yet_another_wizz_tpu._native` when available, with numpy fallbacks.
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, NamedTuple

import numpy as np

from yet_another_wizz_tpu import _native
from yet_another_wizz_tpu.coordinates import chord_to_angle

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "TileSet",
    "bucket_size",
    "build_tile_set",
    "decode_fixedpoint_lanes",
    "encode_fixedpoint_lanes",
    "lane_encoding",
    "lane_quantisation_scale",
    "morton_codes",
    "preferred_tile_layout",
    "uniform_weight_fill",
]

CHANNEL_XYZ_HI = slice(0, 3)
CHANNEL_XYZ_LO = slice(3, 6)
CHANNEL_WEIGHT = 6
CHANNEL_ZBIN = 7
NUM_CHANNELS = 8

DEFAULT_TILE_SIZE = 512

LANE_ENCODING_ENV = "YAWT_LANE_ENCODING"

# Fixed-point lane encoding: per-point payload crossing the host-device
# link drops from 32 B (xyz as (hi, lo) float32 pairs + weight + zbin) to
# 17 B (3x int32 tile-relative offsets + float32 weight bit-cast + int8
# redshift-bin index — bin indices are small ints, so the narrow lane is
# LOSSLESS), which matters precisely on link-bound devices (the uncached
# survey-scale measurement runs at the transfer floor, see ROADMAP.md).
# Two further lossless elisions apply per tile set: uniform-weight
# catalogs drop the weight channel (-4 B, reconstructed from the
# per-tile point count) and unbinned catalogs drop the zero bin lane
# (-1 B), so the common bulk — randoms, the unknown sample — crosses at
# 12 B/point.
# Channels of the packed int32 layout:
FIXEDPOINT_CHANNELS = 4  # [qx, qy, qz, weight (bitcast)]
FIXEDPOINT_PARAMS = 8  # [cx_hi, cy_hi, cz_hi, cx_lo, cy_lo, cz_lo, scale, 0]

# The per-tile quantisation step is a power of two >= maxabs_offset/2^30,
# floored so float32 products with it never go subnormal (devices may
# flush subnormals; an exact decode needs normal arithmetic throughout).
_SCALE_FLOOR = 2.0**-80


def lane_encoding() -> str:
    """The active packed-lane encoding: ``"fixedpoint"`` (default; int32
    tile-relative coordinates + int8 bin lane, 17 B/point across the
    host-device link) or ``"float"`` (the raw (hi, lo) float32 lanes,
    32 B/point), selectable via the ``YAWT_LANE_ENCODING`` environment
    variable.

    The fixed-point quantisation moves each point by at most
    ``sqrt(3)/2 * scale`` with ``scale <= 2 * chord(tile_radius) / 2^30``
    — well inside the exact-boundary audit band at the smallest
    survey-relevant threshold, i.e. inside the error class the float32
    engine already occupies; :func:`lane_quantisation_scale` widens the audit band
    accordingly.
    """
    value = os.environ.get(LANE_ENCODING_ENV, "fixedpoint").strip().lower()
    if value not in ("float", "fixedpoint"):
        raise ValueError(
            f"{LANE_ENCODING_ENV} must be 'float' or 'fixedpoint', "
            f"got {value!r}"
        )
    return value


def encode_fixedpoint_lanes(
    lane_data: NDArray,
    tile_center: NDArray,
    chunk_tiles: int = 4096,
    zbin_dtype: type = np.int8,
) -> tuple[NDArray, NDArray, NDArray]:
    """Encode float32 (hi, lo) lanes into the packed int32 representation.

    Per tile, coordinates are stored as ``q = rint((xyz - center) / scale)``
    with a power-of-two ``scale`` chosen so ``|q| <= 2^30`` — the
    power-of-two choice makes the device decode exact (float32 products
    with it are just exponent shifts). The weight float32 lane is bit-cast
    into the fourth int32 channel losslessly; the redshift-bin lane holds
    small integer indices and crosses as ``zbin_dtype`` (int8 for up to
    128 bins, int16 beyond — both lossless).

    Returns ``(packed, params, zbins)``: int32 ``(N, 4, T)``, float32
    ``(N, 8)`` per-tile decode parameters (center split into a float32
    (hi, lo) pair, plus the scale), and the ``(N, T)`` integer bin lane.
    """
    if _native.NATIVE_ENABLED and zbin_dtype == np.int8:
        return _native.encode_fixedpoint(lane_data, tile_center, _SCALE_FLOOR)

    num_tiles, _, tile_size = lane_data.shape
    packed = np.empty((num_tiles, FIXEDPOINT_CHANNELS, tile_size), np.int32)
    params = np.zeros((num_tiles, FIXEDPOINT_PARAMS), np.float32)
    params[:, 6] = np.float32(_SCALE_FLOOR / 2**30)
    for start in range(0, num_tiles, chunk_tiles):
        stop = min(start + chunk_tiles, num_tiles)
        sub = lane_data[start:stop]
        xyz = sub[:, CHANNEL_XYZ_HI, :].astype(np.float64)
        xyz += sub[:, CHANNEL_XYZ_LO, :]
        center = tile_center[start:stop]  # (n, 3) float64
        offsets = xyz - center[:, :, None]
        maxabs = np.abs(offsets).max(axis=(1, 2))
        scale = np.exp2(
            np.ceil(np.log2(np.maximum(maxabs, _SCALE_FLOOR) / 2**30))
        )
        packed[start:stop, 0:3, :] = np.rint(
            offsets / scale[:, None, None]
        ).astype(np.int32)
        c_hi = center.astype(np.float32)
        params[start:stop, 0:3] = c_hi
        params[start:stop, 3:6] = (center - c_hi.astype(np.float64)).astype(
            np.float32
        )
        params[start:stop, 6] = scale.astype(np.float32)
    packed[:, 3, :] = np.ascontiguousarray(
        lane_data[:, CHANNEL_WEIGHT, :]
    ).view(np.int32)
    zbins = lane_data[:, CHANNEL_ZBIN, :].astype(zbin_dtype)
    return packed, params, zbins


def uniform_weight_fill(lane_data: NDArray):
    """Detect an elidable weight lane.

    Returns ``(w0, counts)`` when every tile holds a front-contiguous run
    of points sharing ONE nonzero weight ``w0`` followed by zero-weight
    padding — the layout the packer produces for unit-weight catalogs
    (randoms, unweighted data): the weight lane is then fully determined
    by the per-tile point count and can be dropped from the link transfer
    (17 -> 13 B/point, lossless). Returns ``None`` for anything else —
    per-point weights, scalar (kappa) lanes, zero-weight points inside a
    tile, or an empty tile set — in which case the weight channel crosses
    the link bit-cast as usual.
    """
    w = lane_data[:, CHANNEL_WEIGHT, :]
    mask = w != 0.0
    counts = mask.sum(axis=1, dtype=np.int64)
    if counts.sum() == 0:
        return None
    tile_size = w.shape[1]
    front = np.arange(tile_size)[None, :] < counts[:, None]
    if not np.array_equal(mask, front):
        return None
    first = int(np.argmax(counts > 0))
    w0 = w[first, 0]
    if not np.all((w == 0.0) | (w == w0)):
        return None
    return float(w0), counts


_decode_fn = None


def _decode_impl(packed, params, zbins):
    """Traceable body of the fixed-point decode (see
    :func:`decode_fixedpoint_lanes` for the numerical contract); shared
    between the split-array and fused-buffer upload paths."""
    import jax
    import jax.numpy as jnp

    q = packed[..., 0:3, :]
    if packed.shape[-2] == 3:
        # elided weight lane (uniform_weight_fill): reconstruct
        # from the per-tile point count (params[..., 7], exact in
        # float32 for any practical tile size) and the shared
        # weight value (params[..., 8]); zero-padded tiles decode
        # to all-zero weights through their zero params row
        count = params[..., 7][..., None, None]
        w0 = params[..., 8][..., None, None]
        slot = jnp.arange(packed.shape[-1], dtype=jnp.float32)
        weight = jnp.where(slot < count, w0, jnp.float32(0.0))
    else:
        weight = jax.lax.bitcast_convert_type(
            packed[..., 3:4, :], jnp.float32
        )
    if zbins.shape[-1] == 0:
        # elided bin lane (host_lanes: unbinned catalogs): the
        # lane is identically zero on the host side
        zbin = jnp.zeros(
            (*packed.shape[:-2], 1, packed.shape[-1]), jnp.float32
        )
    else:
        zbin = zbins[..., None, :].astype(jnp.float32)  # exact ints
    q_lo = ((q + 16384) & 0x7FFF) - 16384  # in [-2^14, 2^14)
    q_hi = q - q_lo  # multiple of 2^15, <= 16 significant bits
    s = params[..., 6][..., None, None]
    va = q_hi.astype(jnp.float32) * s  # exact
    vb = q_lo.astype(jnp.float32) * s  # exact
    c_hi = params[..., 0:3][..., :, None]
    c_lo = params[..., 3:6][..., :, None]
    # TwoSum(c_hi, va): s1 + e1 == c_hi + va exactly
    s1 = c_hi + va
    t = s1 - c_hi
    e1 = (c_hi - (s1 - t)) + (va - t)
    lo_t = (e1 + vb) + c_lo
    # renormalise with a second TwoSum: hi + lo == s1 + lo_t exactly
    hi = s1 + lo_t
    t2 = hi - s1
    lo = (s1 - (hi - t2)) + (lo_t - t2)
    return jnp.concatenate([hi, lo, weight, zbin], axis=-2)


def decode_fixedpoint_lanes():
    """The jitted device decode: packed int32 lanes -> the engine's float32
    8-channel layout, bit-compatible in structure with the float encoding.

    The decode is EXACT given the encoded integers: ``q`` is split into a
    high part (multiple of 2^15, <= 16 significant bits) and a low part
    (< 2^14), whose float32 products with the power-of-two scale are both
    exact; a Knuth two-sum against the float32 (hi, lo) center split then
    renormalises into the engine's compensated (hi, lo) pair with residual
    error ~2^-39 of the tile radius — three orders below the quantisation
    step the audit band accounts for. Handles any number of leading batch
    axes (the ring layout decodes ``(devices, shard, 5, T)`` blocks).
    """
    global _decode_fn
    if _decode_fn is None:
        import jax

        _decode_fn = jax.jit(_decode_impl)
    return _decode_fn


LANE_UPLOAD_ENV = "YAWT_LANE_UPLOAD"


def lane_upload_mode() -> str:
    """How a fixed-point payload crosses the host-device link:
    ``"fused"`` (default) concatenates the packed data, decode
    parameters and bin lane into ONE contiguous uint8 buffer per block
    — a single transfer instead of three, because each transfer pays a
    fixed staging cost and small transfers run below peak bandwidth —
    with an on-device
    slice + bitcast feeding the identical decode. ``"split"`` restores
    the three-array upload (``YAWT_LANE_UPLOAD=split``)."""
    value = os.environ.get(LANE_UPLOAD_ENV, "fused").strip().lower()
    if value not in ("fused", "split"):
        raise ValueError(
            f"{LANE_UPLOAD_ENV} must be 'fused' or 'split', got {value!r}"
        )
    return value


def fuse_host_lanes(host: HostLanes) -> NDArray:
    """One contiguous uint8 buffer holding a fixed-point payload's
    packed data, decode parameters and (unless elided) bin lane,
    back-to-back in that order. The layout is fully determined by the
    array shapes, which :meth:`TileSet.device_data` passes statically
    to :func:`_decode_fused_fn`; the int32/float32 segments come first
    so their byte offsets stay 4-aligned."""
    parts = [
        np.ascontiguousarray(host.data).view(np.uint8).ravel(),
        np.ascontiguousarray(host.params).view(np.uint8).ravel(),
    ]
    if host.zbins is not None and host.zbins.size:
        parts.append(np.ascontiguousarray(host.zbins).view(np.uint8).ravel())
    return np.concatenate(parts)


@functools.lru_cache(maxsize=128)
def _decode_fused_fn(
    num_tiles: int,
    num_chan: int,
    tile_size: int,
    params_width: int,
    zbin_itemsize: int,
):
    """Jitted uint8-buffer decode for one payload geometry: slice the
    fused buffer at static offsets, bitcast each segment back to its
    lane dtype (XLA packs the trailing length-4 byte axis little-endian,
    matching the host's ``.view(uint8)`` layout — asserted bit-exact
    against the split path in tests/test_engine.py), and run the shared
    :func:`_decode_impl`. Cached per shape: block-shape bucketing
    (``device_pad_base``) keeps the distinct geometries to a handful per
    run."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    data_bytes = num_tiles * num_chan * tile_size * 4
    params_bytes = num_tiles * params_width * 4

    @jax.jit
    def decode(buf):
        packed = lax.bitcast_convert_type(
            buf[:data_bytes].reshape(num_tiles, num_chan, tile_size, 4),
            jnp.int32,
        )
        params = lax.bitcast_convert_type(
            buf[data_bytes:data_bytes + params_bytes].reshape(
                num_tiles, params_width, 4
            ),
            jnp.float32,
        )
        zbin_start = data_bytes + params_bytes
        if zbin_itemsize == 0:
            zbins = jnp.zeros((num_tiles, 0), jnp.int8)
        elif zbin_itemsize == 1:
            zbins = lax.bitcast_convert_type(
                buf[zbin_start:zbin_start + num_tiles * tile_size],
                jnp.int8,
            ).reshape(num_tiles, tile_size)
        else:
            zbins = lax.bitcast_convert_type(
                buf[
                    zbin_start:zbin_start + num_tiles * tile_size * 2
                ].reshape(num_tiles, tile_size, 2),
                jnp.int16,
            )
        return _decode_impl(packed, params, zbins)

    return decode


def lane_quantisation_scale(tiles: TileSet) -> float:
    """Upper bound on the active fixed-point quantisation step of a tile
    set (0 under the float encoding): the encoder's power-of-two scale is
    at most ``2 * maxabs_offset / 2^30`` and per-tile offsets are bounded
    by the cap chord radius. Consumed by the exact-boundary audit to widen
    its threshold band (ops/paircount.py:audit_boundary_counts)."""
    if lane_encoding() != "fixedpoint" or tiles.num_tiles == 0:
        return 0.0
    max_chord = 2.0 * np.sin(min(float(tiles.tile_radius.max()), np.pi) / 2.0)
    return 2.0 * max(max_chord, _SCALE_FLOOR) / 2**30


def bucket_size(n: int, base: int = 512, multiple_of: int = 1) -> int:
    """Smallest allowed size ``>= n`` from a quarter-octave geometric grid
    (powers of two and their 1.25x / 1.5x / 1.75x multiples, floored at
    ``base``), rounded up to a multiple of ``multiple_of``.

    Device programs are compiled against array shapes; padding dynamic
    sizes (tile counts, patch-pair slots, pair-list lengths) to this grid
    bounds the number of distinct compiled programs (four per octave)
    while wasting at most 25% padding. A compile costs seconds to minutes
    at survey scale, so shape reuse outweighs the padding overhead.

    ``multiple_of`` keeps callers that reshape into fixed-size chunks safe
    for chunk sizes that do not divide the quarter-octave grid points (the
    grid itself only guarantees divisibility by powers of two up to 4).
    """

    def round_up(size: int) -> int:
        return -(-size // multiple_of) * multiple_of

    if n <= base:
        return round_up(base)
    octave = 1 << ((int(n) - 1).bit_length() - 1)  # largest power of 2 < n
    for mult in (1.0, 1.25, 1.5, 1.75, 2.0):
        size = int(octave * mult)
        if size >= n:
            return round_up(size)
    return round_up(2 * octave)  # unreachable


def preferred_tile_layout(
    catalog,
    num_bins: int,
    max_angle: float,
    *,
    equal_bin_counting: bool,
    tile_size: int | None = None,
) -> str:
    """Choose the tile layout for a binned tile set of a measurement.

    The ``zmajor`` layout (bin-coherent tiles) enables per-tile
    angular-cutoff pruning and disjoint-bin dropping in
    :func:`~yet_another_wizz_tpu.ops.linkage.build_tile_pairs`, but inflates
    tile bounding-cap radii by ~sqrt(num_bins) because a redshift slice
    spreads over the whole patch footprint.

    For equal-bin counting (both sides binned, autocorrelation style) the
    disjoint-bin drop divides the pair grid by ~num_bins, cancelling the
    radius inflation in the worst case and winning outright whenever the
    angular cutoff contributes — so zmajor is used unconditionally. For
    binned-rows/unbinned-columns counting there is no disjoint drop, so
    zmajor pays off only when the angular cutoff dominates the inflated cap
    radii (large scales, dense catalogs, or many small patches).
    """
    if num_bins <= 0:
        return "spatial"
    if equal_bin_counting:
        return "zmajor"
    if tile_size is None:
        tile_size = DEFAULT_TILE_SIZE
    counts = np.asarray(catalog.get_num_records(), dtype=np.float64)
    tiles_per_patch = np.maximum(1.0, counts / tile_size)
    radius_spatial = catalog.patch_radii / np.sqrt(tiles_per_patch)
    radius_zmajor = np.median(radius_spatial) * np.sqrt(num_bins)
    return "zmajor" if max_angle >= radius_zmajor else "spatial"


def morton_codes(xyz: NDArray, bits: int = 10) -> NDArray:
    """Interleaved-bit (Morton) codes for 3D points in ``[-1, 1]^3``.

    Sorting by these codes groups spatial neighbours, which keeps the
    bounding caps of consecutive point tiles compact.
    """
    if _native.NATIVE_ENABLED:
        return _native.morton_codes(np.asarray(xyz, np.float64), bits)

    quantised = np.clip(
        ((xyz + 1.0) * (0.5 * (1 << bits))).astype(np.int64), 0, (1 << bits) - 1
    )
    codes = np.zeros(len(xyz), dtype=np.int64)
    for bit in range(bits):
        for dim in range(3):
            codes |= ((quantised[:, dim] >> bit) & 1) << (3 * bit + dim)
    return codes


def _pack_numpy(xyz, pair_weights, zbins, dest, num_tiles, tile_size):
    """Numpy fallback for the packed-layout scatter."""
    lane_data = np.zeros((num_tiles, NUM_CHANNELS, tile_size), np.float32)
    tiles = dest // tile_size
    lanes = dest - tiles * tile_size
    hi = xyz.astype(np.float32)
    lo = (xyz - hi.astype(np.float64)).astype(np.float32)
    for dim in range(3):
        lane_data[tiles, dim, lanes] = hi[:, dim]
        lane_data[tiles, 3 + dim, lanes] = lo[:, dim]
    lane_data[tiles, CHANNEL_WEIGHT, lanes] = pair_weights.astype(np.float32)
    lane_data[tiles, CHANNEL_ZBIN, lanes] = zbins.astype(np.float32)
    return lane_data


def _caps_numpy(xyz, dest, num_tiles, tile_size):
    """Numpy fallback for the tile bounding caps."""
    tiles = dest // tile_size
    sums = np.zeros((num_tiles, 3))
    for dim in range(3):
        sums[:, dim] = np.bincount(
            tiles, weights=xyz[:, dim], minlength=num_tiles
        )
    norms = np.linalg.norm(sums, axis=1)
    centers = np.zeros((num_tiles, 3))
    centers[:, 0] = 1.0
    nonempty = norms > 0
    centers[nonempty] = sums[nonempty] / norms[nonempty, None]

    chord = np.linalg.norm(xyz - centers[tiles], axis=1)
    max_chord = np.zeros(num_tiles)
    np.maximum.at(max_chord, tiles, chord)
    return centers, max_chord


class HostLanes(NamedTuple):
    """A tile set's lane payload ready for host-to-device transfer."""

    encoding: str  # "float" or "fixedpoint"
    data: NDArray  # float32 (N, 8, T) lanes, or int32 (N, 4, T) packed
    # ((N, 3, T) when the uniform weight lane is elided)
    params: NDArray | None  # float32 (N, 8) decode parameters (fixedpoint;
    # (N, 9) with per-tile count + shared weight when the lane is elided)
    zbins: NDArray | None = None  # int8/int16 (N, T) bin lane (fixedpoint)


@dataclass(eq=False)  # identity semantics: field-wise eq over numpy arrays
# is ambiguous anyway, and identity hashing lets weakrefs key the pair-list
# memo (ops/linkage.py)
class TileSet:
    """A catalog packed into fixed-size point tiles for the pair-count engine.

    Attributes:
        lane_data:
            float32 array ``(num_tiles, 8, tile_size)``; channel layout is
            ``[x_hi, y_hi, z_hi, x_lo, y_lo, z_lo, weight, zbin]``.
        tile_patch:
            Patch id of each tile (every tile belongs to exactly one patch).
        tile_center:
            Unit-sphere bounding-cap centers, float64 ``(num_tiles, 3)``.
        tile_radius:
            Bounding-cap opening angles in radian, float64 ``(num_tiles,)``.
        patch_tile_start / patch_tile_stop:
            Per-patch [start, stop) ranges into the tile arrays.
        sum_weights:
            Per (bin, patch) sum of pair weights, float64 ``(B, P)`` —
            the normalisation input. For unbinned tile sets ``B == 1``.
        sum_kappa:
            Per (bin, patch) weighted sum of the scalar field (None if the
            catalog has no kappa values).
        tile_zmin / tile_zmax:
            Per-tile redshift-bin index range (inclusive). Points are
            sorted by bin within each patch, so tiles are bin-coherent and
            the range enables per-tile angular-cutoff pruning in
            :func:`~yet_another_wizz_tpu.ops.linkage.build_tile_pairs`.
            Unbinned tile sets carry zeros; tiles without points carry the
            empty range ``(0, -1)``.
        num_bins:
            Number of redshift bins (0 for an unbinned tile set).
        num_points:
            Number of (non-padding) points retained in the tiles.
    """

    lane_data: NDArray
    tile_patch: NDArray
    tile_center: NDArray
    tile_radius: NDArray
    patch_tile_start: NDArray
    patch_tile_stop: NDArray
    sum_weights: NDArray
    sum_kappa: NDArray | None
    tile_zmin: NDArray
    tile_zmax: NDArray
    num_bins: int
    num_points: int
    tile_size: int = DEFAULT_TILE_SIZE
    device_pad_base: int = 512
    """Tile-axis padding floor for :meth:`device_data`: 512 keeps full
    catalogs of nearby sizes on one compiled shape (compiles are slow);
    the blocked out-of-core path passes 64 —
    its few-dozen-tile blocks would otherwise pay up to 8x transfer
    padding per block pair, and all blocks of a run share one shape."""
    _cache_token: object = field(default=None, repr=False)
    _upload_lock: object = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    _pair_memo: object = field(default=None, repr=False, compare=False)
    """Per-tile-set LRU of pruned tile-pair lists, populated and bounded by
    :func:`yet_another_wizz_tpu.ops.linkage.build_tile_pairs` (keyed on the
    column tile set + linkage inputs). Lives on the ROW tile set so the memo
    is dropped with its catalog's tile cache."""

    def host_lanes(self, padded_tiles: int | None = None) -> HostLanes:
        """The lane payload to move across the host-device link, in the
        active encoding (:func:`lane_encoding`), with the tile axis
        zero-padded to ``padded_tiles`` when given. Fixed-point payloads
        carry 17 B/point plus 32 B/tile of decode parameters — minus
        4 B/point when the weight lane is uniform and elided
        (:func:`uniform_weight_fill`, +4 B/tile of parameters) and minus
        1 B/point when the bin lane is identically zero (unbinned
        catalogs), so the common bulk crosses at 12 B/point; float
        payloads are the raw 32 B/point lanes."""
        num_pad = 0
        if padded_tiles is not None and padded_tiles > self.num_tiles:
            num_pad = padded_tiles - self.num_tiles

        def pad(arr):
            if not num_pad:
                return arr
            return np.concatenate(
                [arr, np.zeros((num_pad, *arr.shape[1:]), dtype=arr.dtype)]
            )

        if lane_encoding() == "fixedpoint":
            packed, params, zbins = encode_fixedpoint_lanes(
                self.lane_data,
                self.tile_center,
                zbin_dtype=np.int8 if self.num_bins <= 128 else np.int16,
            )
            fill = uniform_weight_fill(self.lane_data)
            if fill is not None:
                # uniform-weight catalogs (randoms, unweighted data): drop
                # the weight channel from the transfer (17 -> 13 B/point)
                # and ship the per-tile point count + shared value in the
                # decode parameters instead; the payload self-describes
                # through the channel count (3) and params width (9)
                w0, counts = fill
                packed = np.ascontiguousarray(packed[:, :3, :])
                params = np.concatenate(
                    [
                        params,
                        np.full((len(params), 1), w0, dtype=np.float32),
                    ],
                    axis=1,
                )
                params[:, 7] = counts
            if self.num_bins == 0:
                # unbinned catalogs (the unknown sample in a
                # cross-correlation and its randoms) hold an
                # identically-zero bin lane: elide it from the transfer —
                # the decode reconstructs zeros from the zero-width
                # payload (13 -> 12 B/point for the uniform-weight
                # bulk). LOSSLESS: padded slots and bin-0 points decode
                # to the same zero either way. Gated on the DECLARED bin
                # count, not the lane contents: a binned catalog's block
                # that happens to land entirely in bin 0 must ship the
                # same lane shape as its sibling blocks, or the shared
                # decode program (device_pad_base shape bucketing)
                # would recompile per block.
                zbins = zbins[:, :0]
            return HostLanes(
                "fixedpoint", pad(packed), pad(params), pad(zbins)
            )
        return HostLanes("float", pad(self.lane_data), None)

    def device_data(self):
        """The lane data as a device-resident float32 array (uploaded once
        and cached; repeated engine calls must not re-transfer the catalog
        through the host-device link). Under the fixed-point encoding the
        transfer carries the packed int32 payload and a one-shot jitted
        decode expands it to the engine layout in HBM — consumers see the
        identical 8-channel array either way.

        The tile axis is padded with zero tiles to a bucketed size
        (:func:`bucket_size`): the engine programs are compiled against the
        array shape, and unbucketed tile counts would force a fresh XLA
        compile (seconds to minutes) for every
        catalog size. Pad tiles are never referenced by a tile-pair list
        and carry zero weights.
        """
        if self._cache_token is None:
            # double-checked under the lock: the blocked path's row and
            # column prefetch workers can warm_upload the same cached
            # TileSet concurrently, and an unguarded check-then-set would
            # transfer the full block twice (transient 2x HBM + wasted
            # link bandwidth on exactly the hardware this cache serves)
            with self._upload_lock:
                if self._cache_token is None:
                    import jax.numpy as jnp

                    from yet_another_wizz_tpu.utils.devicemem import track

                    padded_tiles = bucket_size(
                        self.num_tiles, base=self.device_pad_base
                    )
                    host = self.host_lanes(padded_tiles)
                    if host.encoding == "fixedpoint":
                        if lane_upload_mode() == "fused":
                            # ONE transfer per block: each transfer pays
                            # a fixed staging cost and small transfers
                            # run below peak rate
                            staged = track(
                                jnp.asarray(fuse_host_lanes(host)),
                                "lane_staging",
                            )
                            token = _decode_fused_fn(
                                host.data.shape[0],
                                host.data.shape[1],
                                host.data.shape[2],
                                host.params.shape[1],
                                0
                                if host.zbins is None
                                or host.zbins.shape[-1] == 0
                                else host.zbins.dtype.itemsize,
                            )(staged)
                        else:
                            token = decode_fixedpoint_lanes()(
                                *track(
                                    [
                                        jnp.asarray(host.data),
                                        jnp.asarray(host.params),
                                        jnp.asarray(host.zbins),
                                    ],
                                    "lane_staging",
                                )
                            )
                    else:
                        token = jnp.asarray(host.data)
                    # HBM accounting (utils/devicemem.py): the decoded
                    # lanes live as long as this TileSet does — the
                    # resident-tile cache's working set is the sum of
                    # these tokens
                    object.__setattr__(
                        self, "_cache_token", track(token, "tile_lanes")
                    )
        return self._cache_token

    @property
    def num_tiles(self) -> int:
        return len(self.tile_patch)

    @property
    def num_patches(self) -> int:
        return len(self.patch_tile_start)

    @property
    def binned(self) -> bool:
        return self.num_bins > 0

    def patch_tiles(self, patch_id: int) -> NDArray:
        """Indices of the tiles belonging to one patch."""
        return np.arange(
            self.patch_tile_start[patch_id], self.patch_tile_stop[patch_id]
        )

    def bin_sum_weights(self, num_bins: int) -> NDArray:
        """Per (bin, patch) sum of weights broadcast to ``num_bins`` bins
        (unbinned tile sets contribute the same total to every bin)."""
        if self.binned:
            if num_bins != self.num_bins:
                raise ValueError("number of bins does not match tile set")
            return self.sum_weights
        return np.broadcast_to(
            self.sum_weights, (num_bins, self.num_patches)
        ).copy()


def build_tile_set(
    xyz: NDArray,
    patch_ids: NDArray,
    num_patches: int,
    *,
    weights: NDArray | None = None,
    zbins: NDArray | None = None,
    num_bins: int = 0,
    kappa: NDArray | None = None,
    tile_size: int = DEFAULT_TILE_SIZE,
    mode_weights: NDArray | None = None,
    layout: str = "spatial",
    device_pad_base: int = 512,
) -> TileSet:
    """Build a :class:`TileSet` from per-point arrays.

    Args:
        xyz: float64 unit-sphere positions, shape ``(N, 3)``.
        patch_ids: integer patch assignment per point.
        num_patches: total number of patches (patches may be empty).
        weights: optional per-point weights (default 1); used for the
            ``sum_weights`` normalisation.
        zbins: per-point redshift-bin index in ``[0, num_bins)``; points
            outside the binning (negative or >= num_bins) are dropped,
            mirroring the reference where out-of-range points enter no tree.
        num_bins: number of redshift bins (0 = unbinned).
        kappa: optional per-point scalar field values.
        tile_size: points per tile (a power of two; the Pallas engine needs one).
        mode_weights: pair weights actually written to the weight channel
            (e.g. ``kappa * weights`` for scalar counting modes); defaults
            to ``weights``.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    n = len(xyz)
    patch_ids = np.asarray(patch_ids)
    weights = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    pair_weights = (
        weights if mode_weights is None else np.asarray(mode_weights, np.float64)
    )

    if zbins is not None and num_bins > 0:
        zbins = np.asarray(zbins)
        keep = (zbins >= 0) & (zbins < num_bins)
        xyz, patch_ids, weights = xyz[keep], patch_ids[keep], weights[keep]
        pair_weights = pair_weights[keep]
        zbins = zbins[keep].astype(np.float64)
        kappa = kappa[keep] if kappa is not None else None
    else:
        num_bins = 0
        zbins = np.zeros(len(xyz), dtype=np.float64)

    # sort: group by patch, Morton-order within ("spatial"), optionally by
    # redshift bin first ("zmajor": Morton within each (patch, bin)).
    # zmajor makes tiles bin-coherent — enabling per-tile angular-cutoff
    # pruning and disjoint-bin dropping in the linkage — at the cost of
    # inflating tile bounding caps by ~sqrt(num_bins) (a redshift slice
    # spreads over the whole patch footprint). Callers choose zmajor only
    # when the angular cutoff dominates the cap radii (see
    # correlation.measurements._prefer_zmajor_layout).
    if layout not in ("spatial", "zmajor"):
        raise ValueError(f"unknown tile layout '{layout}'")
    use_zbin_key = layout == "zmajor" and num_bins > 0
    if (
        _native.NATIVE_ENABLED
        and len(xyz)
        and num_patches < 2**15  # patch field of the composite sort key
        and num_bins < 2**16  # zbin field (int16 bin-lane bound)
    ):
        # one parallel radix argsort over a composite (patch, zbin,
        # morton) uint64 key plus parallel permutation gathers — the
        # block-packing hot path of the out-of-core loop, where
        # np.lexsort's three stable single-threaded passes and the five
        # fancy-index copies dominated the build wall
        shared_pair_weights = pair_weights is weights
        order = _native.sort_order(
            np.ascontiguousarray(patch_ids, np.int32),
            zbins.astype(np.int32) if use_zbin_key else None,
            morton_codes(xyz),
        )
        xyz = _native.gather_f64(xyz, order)
        patch_ids = _native.gather_i32(patch_ids, order)
        weights = _native.gather_f64(weights, order)
        pair_weights = (
            weights
            if shared_pair_weights
            else _native.gather_f64(pair_weights, order)
        )
        zbins = _native.gather_f64(zbins, order)
        kappa = _native.gather_f64(kappa, order) if kappa is not None else None
    else:
        if use_zbin_key:
            order = np.lexsort((morton_codes(xyz), zbins, patch_ids))
        else:
            order = np.lexsort((morton_codes(xyz), patch_ids))
        xyz = np.ascontiguousarray(xyz[order])
        patch_ids = patch_ids[order]
        weights = weights[order]
        pair_weights = pair_weights[order]
        zbins = zbins[order]
        kappa = kappa[order] if kappa is not None else None

    counts = np.bincount(patch_ids, minlength=num_patches)
    tiles_per_patch = np.maximum(1, -(-counts // tile_size))  # >=1 tile/patch
    patch_tile_stop = np.cumsum(tiles_per_patch)
    patch_tile_start = patch_tile_stop - tiles_per_patch
    num_tiles = int(patch_tile_stop[-1]) if num_patches else 0

    # destination of each (sorted) point in the padded global layout
    patch_offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    position_in_patch = np.arange(len(xyz)) - patch_offsets[patch_ids]
    dest = (
        patch_tile_start[patch_ids].astype(np.int64) * tile_size
        + position_in_patch
    )

    if _native.NATIVE_ENABLED:
        lane_data = _native.pack_tiles(
            xyz, pair_weights, zbins, dest, num_tiles, tile_size
        )
        tile_center, max_chord = _native.tile_caps(
            xyz, dest, num_tiles, tile_size
        )
    else:
        lane_data = _pack_numpy(
            xyz, pair_weights, zbins, dest, num_tiles, tile_size
        )
        tile_center, max_chord = _caps_numpy(xyz, dest, num_tiles, tile_size)
    tile_radius = chord_to_angle(max_chord)

    # padding rows exist only in the last tile of each patch; park them on
    # the tile center so cap pruning stays tight (weights are already zero)
    for pid in np.nonzero(counts % tile_size)[0]:
        last_tile = patch_tile_stop[pid] - 1
        fill = counts[pid] - (tiles_per_patch[pid] - 1) * tile_size
        lane_data[last_tile, 0:3, fill:] = (
            tile_center[last_tile].astype(np.float32)[:, None]
        )
    for pid in np.nonzero(counts == 0)[0]:
        lane_data[patch_tile_start[pid], 0, :] = 1.0

    # per-tile redshift-bin ranges: dest is nondecreasing row-wise, so each
    # tile is a contiguous row segment; reduce bin min/max per segment
    tile_zmin = np.zeros(num_tiles, dtype=np.int32)
    tile_zmax = np.zeros(num_tiles, dtype=np.int32)
    if num_bins > 0 and len(xyz) and num_tiles:
        tile_idx = dest // tile_size
        tile_range = np.arange(num_tiles)
        starts = np.searchsorted(tile_idx, tile_range, side="left")
        stops = np.searchsorted(tile_idx, tile_range, side="right")
        zb = zbins.astype(np.int32)
        has_rows = stops > starts
        # reduceat only over non-empty tiles: their starts are strictly
        # increasing and < len(zb), and each segment runs to the next
        # non-empty tile's start (empty tiles in between hold no rows).
        # Clipping empty trailing starts into range instead would truncate
        # the last non-empty tile's segment, silently dropping its final
        # point's bin from the range used for pair pruning.
        tile_zmax = np.full(num_tiles, -1, dtype=np.int32)  # empty: never links
        tile_zmin = np.zeros(num_tiles, dtype=np.int32)
        nonempty = np.nonzero(has_rows)[0]
        if len(nonempty):
            tile_zmin[nonempty] = np.minimum.reduceat(zb, starts[nonempty])
            tile_zmax[nonempty] = np.maximum.reduceat(zb, starts[nonempty])

    # per (bin, patch) normalisation sums in float64
    effective_bins = max(num_bins, 1)
    flat_idx = zbins.astype(np.int64) * num_patches + patch_ids
    sum_weights = np.bincount(
        flat_idx, weights=weights, minlength=effective_bins * num_patches
    ).reshape(effective_bins, num_patches)
    sum_kappa = None
    if kappa is not None:
        sum_kappa = np.bincount(
            flat_idx, weights=kappa * weights,
            minlength=effective_bins * num_patches,
        ).reshape(effective_bins, num_patches)

    return TileSet(
        lane_data=lane_data,
        tile_patch=np.repeat(np.arange(num_patches), tiles_per_patch),
        tile_center=tile_center,
        tile_radius=tile_radius,
        patch_tile_start=patch_tile_start,
        patch_tile_stop=patch_tile_stop,
        sum_weights=sum_weights,
        sum_kappa=sum_kappa,
        tile_zmin=tile_zmin,
        tile_zmax=tile_zmax,
        num_bins=num_bins,
        num_points=len(xyz),
        tile_size=tile_size,
        device_pad_base=device_pad_base,
    )
