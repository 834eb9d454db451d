"""The tiled brute-force pair-count engine.

Replaces the reference's dual-tree kd-tree kernel
(/root/reference/src/yaw/catalog/trees.py:303-362) with dense tile-pair
arithmetic:

- for a pair of point tiles, squared chord distances are evaluated
  elementwise from (hi, lo)-split float32 coordinates — the compensated
  difference keeps relative precision ~1e-7 even at arcsecond separations,
  far below plain float32 resolution (a plain ``1 - dot`` formulation is
  useless below ~1e-3 rad);
- pairs are counted cumulatively against per-redshift-bin squared-chord
  thresholds; the per-row thresholds are an exact elementwise select and
  the final (bin, edge) reduction a ``Precision.HIGHEST`` contraction;
- per-pair results accumulate into a ``(patch-pair slot, bin, edge)``
  tensor; host-side float64 post-processing converts cumulative edges into
  per-scale counts.

Two interchangeable execution paths:
- ``xla``: pure jax.numpy (vmap + scan); runs on any backend and is the
  correctness reference for the Pallas kernel;
- ``pallas``: the GPU kernel in :mod:`pallas_paircount` (Pallas, Triton
  route), one program per tile pair and a sorted segment sum into slots.
"""

from __future__ import annotations

from functools import partial
from typing import TYPE_CHECKING

import logging

import jax
import jax.numpy as jnp
import numpy as np

from yet_another_wizz_tpu.ops.tiles import bucket_size

logger = logging.getLogger(__name__)

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu.ops.linkage import TilePairs
    from yet_another_wizz_tpu.ops.tiles import TileSet

__all__ = [
    "CHUNK_SIZE",
    "audit_boundary_counts",
    "count_pairs_tiles",
    "pair_block_counts",
    "resolve_backend",
]

_HIGHEST = jax.lax.Precision.HIGHEST

CHUNK_SIZE = 128
"""Tile pairs per step of the XLA engine's scan. Each step is a handful of
kernel launches, so short steps leave the GPU launch-bound: on an H100 at
the benchmark's 512-point tiles, 128 ran the engine in 30 ms where 16 took
98 ms and 256 took 62 ms (see PERF.md)."""


def resolve_backend(
    backend: str, interpret: bool = False, direct: tuple | None = None
) -> str:
    """The engine that ``backend`` names; ``auto`` picks the faster one.

    ``auto`` takes the Pallas kernel on the GPU in cumulative mode, where
    it beat the XLA engine on an H100, and the XLA engine otherwise: in
    the direct separation-weighted mode and on every other backend.
    ``auto`` never selects an interpreted kernel. An explicit ``pallas``
    on a backend the kernel cannot compile for raises, unless
    ``interpret=True`` asks for the Pallas interpreter."""
    if backend == "auto":
        gpu = jax.default_backend() == "gpu"
        return "pallas" if gpu and direct is None else "xla"
    if backend == "pallas":
        from yet_another_wizz_tpu.ops.pallas_paircount import (
            check_kernel_backend,
        )

        check_kernel_backend(interpret)
    return backend


_table_cache: dict[tuple, jnp.ndarray] = {}


def _device_table(chord2_table) -> jnp.ndarray:
    """Upload a (small) threshold table once per distinct content; repeated
    measurements with the same configuration skip the transfer round trip."""
    arr = np.asarray(chord2_table, dtype=np.float32)
    key = (arr.shape, arr.tobytes())
    dev = _table_cache.get(key)
    if dev is None:
        if len(_table_cache) > 64:
            # FIFO-evict one entry: clearing everything would force all
            # measurements still in flight to re-upload their hot tables
            _table_cache.pop(next(iter(_table_cache)))
        dev = jnp.asarray(arr)
        _table_cache[key] = dev
    return dev


def pair_block_counts(
    lane1: jnp.ndarray,
    lane2: jnp.ndarray,
    chord2_table: jnp.ndarray,
    *,
    cols_binned: bool,
    direct: tuple | None = None,
) -> jnp.ndarray:
    """Cumulative weighted pair counts between two point tiles.

    Args:
        lane1: ``(8, T)`` float32 tile (rows: the redshift-binned catalog).
        lane2: ``(8, T)`` float32 tile (columns).
        chord2_table: ``(B, E)`` float32 squared-chord thresholds per bin.
            In direct mode the table carries the per-bin weight parameter
            block appended after the counting edges (see
            :meth:`yet_another_wizz_tpu.ops.thresholds.DirectEdges.combined_table`).
        cols_binned: require equal bin indices on both sides (both catalogs
            binned, i.e. autocorrelation-style counting).
        direct: static ``(num_sub, num_below, num_above[, small_angle])``
            configuration
            of the direct separation-weighted counting mode, or None.

    Returns:
        ``(B, E)`` float32 tensor; entry (b, e) is the sum of
        ``w_i * w_j`` over pairs with row point in bin b and squared chord
        distance ``<= chord2_table[b, e]`` (times the per-pair separation
        weight in direct mode).

    Channel layout matches :mod:`yet_another_wizz_tpu.ops.tiles`.
    """
    num_bins, num_cols_total = chord2_table.shape
    num_edges = num_cols_total
    if direct is not None:
        from yet_another_wizz_tpu.ops.gweight import num_param_cols

        num_edges = num_cols_total - num_param_cols(direct[1], direct[2])
    tile1 = lane1.T  # (T, 8)

    # squared chord distance with (hi, lo) compensation, shape (T, T)
    chord2 = None
    for dim in range(3):
        d_hi = tile1[:, dim : dim + 1] - lane2[dim : dim + 1, :]
        d_lo = tile1[:, 3 + dim : 4 + dim] - lane2[3 + dim : 4 + dim, :]
        d = d_hi + d_lo
        chord2 = d * d if chord2 is None else chord2 + d * d

    w_cols = lane2[6:7, :]  # (1, T)
    if cols_binned:
        z_rows = tile1[:, 7:8]  # (T, 1)
        z_cols = lane2[7:8, :]
        w_cols_eff = jnp.where(z_rows == z_cols, w_cols, 0.0)  # (T, T)
    else:
        w_cols_eff = jnp.broadcast_to(w_cols, chord2.shape)

    # one-hot of the row bin index; threshold rows are selected with exact
    # elementwise arithmetic — NOT a matmul: a reduced-precision matmul
    # (TF32 on the GPU, bfloat16 elsewhere) would move the bin boundaries
    z_rows = tile1[:, 7:8]
    bin_ids = jnp.arange(num_bins, dtype=jnp.float32)[None, :]
    onehot = (z_rows == bin_ids).astype(jnp.float32)  # (T, B)
    selected = jnp.sum(
        onehot[:, :, None] * chord2_table[None, :, :], axis=1
    )  # (T, E [+ C]); exact: one non-zero product per output element
    thresholds = selected[:, :num_edges]

    if direct is not None:
        from yet_another_wizz_tpu.ops.gweight import apply_direct_weight

        params = [
            selected[:, col : col + 1]
            for col in range(num_edges, num_cols_total)
        ]
        w_cols_eff = apply_direct_weight(
            chord2, params, w_cols_eff,
            num_sub=direct[0], num_below=direct[1], num_above=direct[2],
            small_angle=len(direct) > 3 and direct[3],
        )

    # cumulative counts per row and edge
    row_sums = []
    for e in range(num_edges):
        mask = chord2 <= thresholds[:, e : e + 1]
        row_sums.append(jnp.sum(jnp.where(mask, w_cols_eff, 0.0), axis=1))
    row_counts = jnp.stack(row_sums, axis=1)  # (T, E)

    # reduce rows into bins, weighted by the row weights
    w_rows = tile1[:, 6:7]
    onehot_w = onehot * w_rows  # (T, B)
    return jax.lax.dot_general(
        onehot_w, row_counts,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_HIGHEST,
    )  # (B, E)


def _counting_width(chord2_table, direct: tuple | None) -> int:
    """Number of counting-edge columns of a (possibly combined) table."""
    from yet_another_wizz_tpu.ops.gweight import counting_width

    return counting_width(chord2_table.shape[1], direct)


@partial(
    jax.jit,
    static_argnames=("cols_binned", "num_slots_out", "chunk_size", "direct"),
)
def _count_pairs_xla(
    lane1: jnp.ndarray,
    lane2: jnp.ndarray,
    tile1: jnp.ndarray,
    tile2: jnp.ndarray,
    slots: jnp.ndarray,
    chord2_table: jnp.ndarray,
    *,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    direct: tuple | None = None,
) -> jnp.ndarray:
    """Scan over chunks of tile pairs, vmap within a chunk, scatter-add into
    patch-pair slots. Expects the pair list padded to a chunk multiple with
    pad entries pointing at a dump slot ``>= num real slots``; the output
    slot axis is padded to ``num_slots_out`` (bucketed, so the compiled
    program is reused across pair lists) and sliced by the caller."""
    return scan_scatter_counts(
        lane1, lane2, tile1, tile2, slots, chord2_table,
        cols_binned=cols_binned, num_slots_out=num_slots_out,
        chunk_size=chunk_size, direct=direct,
    )


def scan_scatter_counts(
    lane1, lane2, tile1, tile2, slots, table,
    *,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    direct: tuple | None = None,
    axis_name: str | None = None,
):
    """The XLA scatter-add engine core, shared between single-device
    execution (:func:`_count_pairs_xla`) and the per-device program of
    the sharded path (``parallel.sharded._partial_counts_xla``) — one
    body, so an engine change cannot silently desynchronise the two.

    ``axis_name`` marks the accumulator as device-varying over the named
    shard_map axis (jax tracks varying-ness through the scan carry);
    single-device callers leave it None."""
    num_chunks = tile1.shape[0] // chunk_size
    shape = (num_chunks, chunk_size)

    pair_fn = jax.vmap(
        partial(pair_block_counts, cols_binned=cols_binned, direct=direct),
        in_axes=(0, 0, None),
    )

    def body(acc, chunk):
        idx1, idx2, slot = chunk
        blocks = pair_fn(lane1[idx1], lane2[idx2], table)
        return acc.at[slot].add(blocks), None

    init = jnp.zeros(
        (
            num_slots_out,
            table.shape[0],
            _counting_width(table, direct),
        ),
        dtype=jnp.float32,
    )
    if axis_name is not None:
        # the carry must carry the same device-varying type as the
        # sharded chunk data it accumulates
        init = jax.lax.pcast(init, to="varying", axis_name=axis_name)
    acc, _ = jax.lax.scan(
        body,
        init,
        (tile1.reshape(shape), tile2.reshape(shape), slots.reshape(shape)),
    )
    return acc


def _pair_block_boundary(
    lane1: jnp.ndarray,
    lane2: jnp.ndarray,
    chord2_table: jnp.ndarray,
    band_table: jnp.ndarray,
    *,
    cols_binned: bool,
) -> jnp.ndarray:
    """Scalar bool: does any valid pair of the two tiles fall within the
    float32 resolution band of one of its bin's thresholds? Same distance
    math as :func:`pair_block_counts`."""
    num_bins, num_edges = chord2_table.shape
    tile1 = lane1.T

    chord2 = None
    for dim in range(3):
        d_hi = tile1[:, dim : dim + 1] - lane2[dim : dim + 1, :]
        d_lo = tile1[:, 3 + dim : 4 + dim] - lane2[3 + dim : 4 + dim, :]
        d = d_hi + d_lo
        chord2 = d * d if chord2 is None else chord2 + d * d

    w_rows = tile1[:, 6:7]  # (T, 1)
    w_cols = lane2[6:7, :]  # (1, T)
    # zero marks padding; NEGATIVE weights are real data (kappa modes
    # carry signed kappa * weight), so compare against zero, not > 0
    valid = (w_rows != 0.0) & (w_cols != 0.0)
    if cols_binned:
        valid &= tile1[:, 7:8] == lane2[7:8, :]

    # per-row thresholds/bands of the row's own bin (exact one-hot select)
    z_rows = tile1[:, 7:8]
    bin_ids = jnp.arange(num_bins, dtype=jnp.float32)[None, :]
    onehot = (z_rows == bin_ids).astype(jnp.float32)  # (T, B)
    thresholds = jnp.sum(
        onehot[:, :, None] * chord2_table[None, :, :], axis=1
    )  # (T, E)
    bands = jnp.sum(onehot[:, :, None] * band_table[None, :, :], axis=1)

    hit = jnp.zeros(chord2.shape, dtype=bool)
    for e in range(num_edges):
        near = jnp.abs(chord2 - thresholds[:, e : e + 1]) <= bands[:, e : e + 1]
        hit |= near
    return jnp.any(hit & valid)


@partial(jax.jit, static_argnames=("cols_binned", "chunk_size"))
def _boundary_flags_xla(
    lane1, lane2, tile1, tile2, chord2_table, band_table,
    *,
    cols_binned: bool,
    chunk_size: int,
):
    num_chunks = len(tile1) // chunk_size
    shape = (num_chunks, chunk_size)
    flag_fn = jax.vmap(
        partial(_pair_block_boundary, cols_binned=cols_binned),
        in_axes=(0, 0, None, None),
    )

    def body(_, chunk):
        idx1, idx2 = chunk
        return None, flag_fn(lane1[idx1], lane2[idx2], chord2_table, band_table)

    _, flags = jax.lax.scan(
        body, None, (tile1.reshape(shape), tile2.reshape(shape))
    )
    return flags.reshape(-1)


@partial(jax.jit, static_argnames=("cols_binned", "chunk_size"))
def _boundary_flags_gathered(
    lanes1, lanes2, chord2_table, band_table,
    *,
    cols_binned: bool,
    chunk_size: int,
):
    """Flag pass over PRE-GATHERED per-pair lanes (no tile-set residency):
    the bounded-memory variant for tile sets larger than one device."""
    num_chunks = len(lanes1) // chunk_size
    flag_fn = jax.vmap(
        partial(_pair_block_boundary, cols_binned=cols_binned),
        in_axes=(0, 0, None, None),
    )

    def body(_, chunk):
        l1, l2 = chunk
        return None, flag_fn(l1, l2, chord2_table, band_table)

    _, flags = jax.lax.scan(
        body, None,
        (
            lanes1.reshape(num_chunks, chunk_size, *lanes1.shape[1:]),
            lanes2.reshape(num_chunks, chunk_size, *lanes2.shape[1:]),
        ),
    )
    return flags.reshape(-1)


AUDIT_RESIDENT_BYTES = 2 << 30
"""Combined lane bytes above which the audit's flag pass streams
host-gathered pair windows instead of placing both FULL tile sets on one
device — a count run with columns/ring sharding precisely because the
catalog exceeds one device's memory must not have its audit run out of
memory on that device."""


def audit_boundary_counts(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    counts: NDArray,
    chord2_table: NDArray,
    edges_radian: NDArray,
    *,
    rel_band: float = 1e-6,
    chunk_size: int = CHUNK_SIZE,
) -> tuple[NDArray, int]:
    """Exact-boundary audit: certify or repair float32 edge classification.

    The device engine classifies pairs against float32 squared-chord
    thresholds; a pair whose true distance lies within the float32
    resolution (~1.4e-7 relative) of a bin edge can land on the wrong side
    compared to the float64 reference (a whole pair weight of error in one
    bin, see /root/reference/src/yaw/catalog/trees.py:303-362 for the
    float64 semantics being matched). This pass flags — on device, at full
    engine throughput — every tile pair containing such a boundary-band
    pair, then recomputes exactly the flagged patch-pair slots with the
    float64 host oracle.

    Returns ``(corrected_counts, num_flagged_slots)``; with zero flagged
    slots the device counts are certified free of boundary
    misclassification (remaining deviation is float32 accumulation
    rounding only).
    """
    from yet_another_wizz_tpu.coordinates import angle_to_chord
    from yet_another_wizz_tpu.ops.cpu_oracle import count_pairs_oracle

    if pairs.num_pairs == 0:
        return counts, 0

    # band: engine distance error (relative) plus the float32 rounding of
    # the float64 threshold itself, with a 2x safety margin
    t64 = angle_to_chord(np.asarray(edges_radian, dtype=np.float64)) ** 2
    t32 = np.asarray(chord2_table, dtype=np.float64)
    band = 2.0 * (rel_band * t64 + np.abs(t32 - t64))
    # fixed-point lane quantisation moves each point by <= sqrt(3)/2 * s,
    # perturbing a squared chord by <= 2*sqrt(t)*sqrt(3)/2*(s1+s2) plus a
    # second-order term; widen the band by twice that so flagged-slot
    # recomputation still catches every possible classification flip
    from yet_another_wizz_tpu.ops.tiles import lane_quantisation_scale

    s_sum = lane_quantisation_scale(tiles1) + lane_quantisation_scale(tiles2)
    if s_sum:
        band = band + 2.0 * np.sqrt(3.0 * t64) * s_sum + 3.0 * s_sum**2
    band_table = jnp.asarray(band, dtype=jnp.float32)
    table = jnp.asarray(chord2_table, dtype=jnp.float32)

    num_pairs = pairs.num_pairs
    padded = bucket_size(
        num_pairs, base=chunk_size, multiple_of=chunk_size
    )
    tile1 = np.zeros(padded, dtype=np.int32)
    tile2 = np.zeros(padded, dtype=np.int32)
    tile1[:num_pairs] = pairs.tile1
    tile2[:num_pairs] = pairs.tile2
    # padding repeats pair 0; it only re-tests an already-tested tile pair
    tile1[num_pairs:] = pairs.tile1[0]
    tile2[num_pairs:] = pairs.tile2[0]

    lane_bytes = tiles1.lane_data.nbytes + tiles2.lane_data.nbytes
    if lane_bytes <= AUDIT_RESIDENT_BYTES:
        flags = np.asarray(
            jax.device_get(
                _boundary_flags_xla(
                    tiles1.device_data(),
                    tiles2.device_data(),
                    jnp.asarray(tile1),
                    jnp.asarray(tile2),
                    table,
                    band_table,
                    cols_binned=tiles2.binned,
                    chunk_size=chunk_size,
                )
            )
        )[:num_pairs]
    else:
        # bounded-memory path: stream host-gathered pair windows (device
        # holds ~256 MB of gathered lanes at a time, independent of the
        # catalog size; correct wherever the count itself needed
        # columns/ring sharding to fit)
        per_pair = (
            int(np.prod(tiles1.lane_data.shape[1:]))
            + int(np.prod(tiles2.lane_data.shape[1:]))
        ) * 4
        window = max(chunk_size, (256 << 20) // per_pair // chunk_size * chunk_size)
        flags = np.empty(padded, dtype=bool)
        for start in range(0, padded, window):
            stop = min(start + window, padded)
            idx1 = tile1[start:stop]
            idx2 = tile2[start:stop]
            flags[start:stop] = np.asarray(
                jax.device_get(
                    _boundary_flags_gathered(
                        jnp.asarray(tiles1.lane_data[idx1]),
                        jnp.asarray(tiles2.lane_data[idx2]),
                        table,
                        band_table,
                        cols_binned=tiles2.binned,
                        chunk_size=chunk_size,
                    )
                )
            )
        flags = flags[:num_pairs]

    flagged_slots = np.unique(pairs.slot[flags])
    if len(flagged_slots) == 0:
        return counts, 0

    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
    oracle = count_pairs_oracle(
        xyz1, w1, z1, p1,
        xyz2, w2, (z2 if tiles2.binned else None), p2,
        pairs.slot_patches[flagged_slots],
        np.asarray(edges_radian, dtype=np.float64),
    )
    corrected = np.array(counts, dtype=np.float64, copy=True)
    corrected[flagged_slots] = oracle
    logger.info(
        "boundary audit: %d patch-pair slot(s) recomputed in float64",
        len(flagged_slots),
    )
    return corrected, int(len(flagged_slots))


def _unpack_tileset(tiles: TileSet):
    """Recover per-point float64 arrays from a tile set (hi + lo restores
    the original coordinates to ~1e-15; padding rows carry zero weight)."""
    data = tiles.lane_data.astype(np.float64)
    xyz = (data[:, 0:3, :] + data[:, 3:6, :]).transpose(0, 2, 1).reshape(-1, 3)
    weights = data[:, 6, :].reshape(-1)
    zbins = data[:, 7, :].reshape(-1).astype(int)
    patches = np.repeat(tiles.tile_patch, tiles.tile_size)
    keep = weights != 0.0
    return xyz[keep], weights[keep], zbins[keep], patches[keep]


def _count_pairs_oracle_backend(tiles1, tiles2, pairs, edges_radian):
    from yet_another_wizz_tpu.ops.cpu_oracle import count_pairs_oracle

    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
    return count_pairs_oracle(
        xyz1, w1, z1, p1,
        xyz2, w2, (z2 if tiles2.binned else None), p2,
        pairs.slot_patches, np.asarray(edges_radian, dtype=np.float64),
    )


def count_pairs_tiles(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    chord2_table: NDArray,
    *,
    backend: str = "auto",
    chunk_size: int = CHUNK_SIZE,
    edges_radian: NDArray | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
    defer: bool = False,
    direct: tuple | None = None,
    padded_slots: bool = False,
    interpret: bool = False,
) -> NDArray:
    """Run the pair-count engine over a tile-pair list.

    Returns a float64 numpy array ``(num_slots, B, E)`` of cumulative
    weighted pair counts per patch-pair slot. With ``defer=True`` the
    device float32 array is returned WITHOUT waiting for it — the caller
    fetches later (``np.asarray(jax.device_get(...))``), so the device can
    keep computing queued follow-up counts while earlier results transfer
    and post-process on the host (ignored for the oracle backend, when
    ``audit`` is active, and in multi-process mesh jobs).

    Backends: ``pallas`` (the GPU kernel; ``interpret=True`` runs it in
    the Pallas interpreter, for tests), ``xla`` (portable jax.numpy path),
    ``oracle`` (float64 scipy kd-trees on the host, requires
    ``edges_radian``; used for validation), or ``auto``
    (:func:`resolve_backend`).

    With ``mesh`` (a :class:`jax.sharding.Mesh`) the engine runs sharded
    over the mesh devices with the given ``data_sharding`` layout
    (``replicated``, ``columns`` or ``ring``, see
    :func:`yet_another_wizz_tpu.parallel.count_pairs_sharded`). With
    ``mesh=None`` (the default) the device pool is detected
    automatically (:func:`yet_another_wizz_tpu.parallel.auto_mesh`: all
    local devices of a single-process job, the global mesh of a
    multi-process job);
    ``mesh="single"`` pins plain single-device execution.

    With ``audit=True`` (requires ``edges_radian``) the result passes
    through :func:`audit_boundary_counts`, which repairs any float32
    bin-edge misclassification against the float64 reference semantics.

    With ``direct`` (a static ``(num_sub, num_below, num_above[,
    small_angle])`` tuple)
    the engine runs the direct separation-weighted counting mode:
    ``chord2_table`` must then be the combined counting+parameter table
    (:meth:`yet_another_wizz_tpu.ops.thresholds.DirectEdges.combined_table`)
    and the output edge axis covers only the counting edges. Not
    available with ``audit`` or the ``oracle`` backend, which require the
    union-edge cumulative representation (callers fall back to it).

    With ``padded_slots=True`` (single-device deferred execution only)
    the slot axis of the returned device array keeps the engine's
    BUCKETED padding instead of being sliced to ``num_slots``: jitted
    consumers (the blocked loop's on-device scale reduction) then compile
    once per bucket, and rows ``>= num_slots`` (the dump slot's padding
    counts) must be masked out by the caller.
    """
    if audit and edges_radian is None:
        raise ValueError("audit=True requires 'edges_radian'")
    if padded_slots and (audit or backend == "oracle" or not defer):
        raise ValueError(
            "padded_slots=True requires deferred device execution "
            "(defer=True without audit or the oracle backend)"
        )
    if direct is not None and (audit or backend == "oracle"):
        raise ValueError(
            "direct counting requires the cumulative representation for "
            "audit/oracle execution"
        )
    cols_binned = tiles2.binned
    if cols_binned and tiles1.num_bins != tiles2.num_bins:
        raise ValueError("tile sets have inconsistent binning")
    if not tiles1.binned:
        raise ValueError("first tile set must be binned")

    num_slots = pairs.num_slots
    table = _device_table(chord2_table)

    if pairs.num_pairs == 0:
        width = _counting_width(table, direct)
        rows = bucket_size(num_slots + 1, base=64) if padded_slots else num_slots
        return np.zeros((rows, table.shape[0], width), dtype=np.float64)

    backend = resolve_backend(backend, interpret, direct)

    if mesh == "single":
        # explicit single-device pin (e.g. the pipeline's
        # `execution: devices: 1`): skip automatic pool detection
        mesh = None
    elif mesh is None and backend != "oracle":
        # automatic device pool: a multi-host pod job gets the global
        # mesh (all processes were launched to participate); a
        # single-process job with several local devices gets a local mesh
        # so e.g. a four-GPU host engages all four by default — the analogue
        # of the reference auto-detecting its full worker pool
        # (/root/reference/src/yaw/utils/parallel.py:53-85). Returns
        # None (plain single-device execution) when there is nothing to
        # spread over; see parallel.auto_mesh for the CPU-backend rules.
        from yet_another_wizz_tpu.parallel import auto_mesh

        mesh = auto_mesh()

    if mesh is not None and backend != "oracle":
        if padded_slots:
            raise ValueError(
                "padded_slots=True is only supported on the single-device "
                "engines (the sharded path returns sliced host-shape "
                "results)"
            )
        from yet_another_wizz_tpu.parallel import count_pairs_sharded

        result = count_pairs_sharded(
            tiles1, tiles2, pairs, table,
            mesh=mesh, data_sharding=data_sharding, engine=backend,
            chunk_size=chunk_size, defer=defer and not audit, direct=direct,
            interpret=interpret,
        )
        if not isinstance(result, np.ndarray):
            if defer and not audit:
                return result
            result = np.asarray(jax.device_get(result))
        counts = result.astype(np.float64, copy=False)
        if audit:
            counts, _ = audit_boundary_counts(
                tiles1, tiles2, pairs, counts, chord2_table, edges_radian
            )
        return counts

    if backend == "oracle":
        if edges_radian is None:
            raise ValueError("the 'oracle' backend requires 'edges_radian'")
        return _count_pairs_oracle_backend(tiles1, tiles2, pairs, edges_radian)

    if backend == "pallas":
        from yet_another_wizz_tpu.ops.pallas_paircount import (
            count_pairs_pallas,
        )

        result = count_pairs_pallas(
            tiles1.device_data(),
            tiles2.device_data(),
            pairs,
            table,
            cols_binned=cols_binned,
            interpret=interpret,
            direct=direct,
            padded_slots=padded_slots,
        )
    elif backend == "xla":
        # pad the pair list to a bucketed chunk multiple and the slot axis
        # to a bucketed size; padding pairs go to a dump slot. Bucketing
        # keeps the compiled program reusable across pair lists and patch
        # linkages of different sizes.
        num_pairs = pairs.num_pairs
        num_slots_out = bucket_size(num_slots + 1, base=64)
        padded = bucket_size(
            num_pairs, base=chunk_size, multiple_of=chunk_size
        )
        tile1 = np.zeros(padded, dtype=np.int32)
        tile2 = np.zeros(padded, dtype=np.int32)
        slots = np.full(padded, num_slots, dtype=np.int32)
        tile1[:num_pairs] = pairs.tile1
        tile2[:num_pairs] = pairs.tile2
        slots[:num_pairs] = pairs.slot

        result = _count_pairs_xla(
            tiles1.device_data(),
            tiles2.device_data(),
            jnp.asarray(tile1),
            jnp.asarray(tile2),
            jnp.asarray(slots),
            table,
            cols_binned=cols_binned,
            num_slots_out=num_slots_out,
            chunk_size=chunk_size,
            direct=direct,
        )
        if not padded_slots:
            result = result[:num_slots]
    else:
        raise ValueError(f"unknown backend '{backend}'")

    if defer and not audit:
        return result
    counts = np.asarray(jax.device_get(result), dtype=np.float64)
    if audit:
        counts, _ = audit_boundary_counts(
            tiles1, tiles2, pairs, counts, chord2_table, edges_radian
        )
    return counts
