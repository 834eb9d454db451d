"""Pallas GPU kernel (Triton route) for the tiled pair-count engine.

One program handles one ``(tile_i, tile_j)`` pair of the flat, slot-sorted
tile-pair list (see :mod:`yet_another_wizz_tpu.ops.linkage`):

- the program reads its own row tile, column tile and output index from
  the pair list; nothing ``(T, T)``-sized ever leaves registers;
- it loops over ``(rows, columns)`` sub-blocks of the two tiles,
  computes the compensated (hi, lo) squared chord distances in registers
  (see :mod:`paircount` for the precision rationale), compares them with
  the row's own thresholds (selected exactly from the ``(B, E)`` table by
  bin id) and accumulates per-row cumulative sums;
- the per-row sums fold into the pair's ``(B, E)`` block with elementwise
  selects and sums, never a dot: a float32 dot may run in TF32 on the
  GPU, which would move bin boundaries;
- every program writes its own block, and the blocks are reduced into
  patch-pair slots by one sorted ``segment_sum`` in XLA: deterministic,
  no atomics, no order assumed between programs.

The kernel compiles only for the GPU. ``interpret=True`` runs it in the
Pallas interpreter on any backend; that is for tests and never inferred.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from yet_another_wizz_tpu.ops.gweight import apply_direct_weight, counting_width
from yet_another_wizz_tpu.ops.tiles import bucket_size

if TYPE_CHECKING:
    from yet_another_wizz_tpu.ops.linkage import TilePairs

__all__ = [
    "check_kernel_backend",
    "count_pairs_pallas",
    "pallas_partial_counts",
]

BLOCKS = {False: (16, 256, 2), True: (16, 64, 4)}
"""``(rows, columns, warps)`` of one program's sub-block, keyed by the
direct mode. The direct weight keeps about twice as many values live per
pair, so it needs a smaller block to stay in registers. Both were the
fastest of the shapes tried on an H100 at the 512-point tiles of the
benchmark (see PERF.md)."""


def check_kernel_backend(interpret: bool) -> None:
    """Refuse to compile the kernel for a backend it has no lowering for:
    the Triton route exists only on the GPU. No fallback is taken."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the 'pallas' engine compiles only for the GPU (backend is "
            f"'{jax.default_backend()}'); use backend='xla', or "
            "interpret=True to run the kernel in the Pallas interpreter"
        )


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _paircount_kernel(
    tile1_ref,  # (P,) int32 row-tile index; -1 marks padding
    tile2_ref,  # (P,) int32 column-tile index
    lane1_ref,  # (N1, 8, T) row tiles
    lane2_ref,  # (N2, 8, T) column tiles
    table_ref,  # (B, E [+ C]) thresholds [+ direct-mode parameters]
    out_ref,  # (Bp, Ep) block of this tile pair
    *,
    tile_size: int,
    num_bins: int,
    num_edges: int,
    num_params: int,
    cols_binned: bool,
    direct: tuple | None,
    row_block: int,
    col_block: int,
):
    k = pl.program_id(0)
    t1 = tile1_ref[k]
    t2 = tile2_ref[k]
    bins_pad, edges_pad = out_ref.shape
    bin_iota = jax.lax.broadcasted_iota(jnp.float32, (1, bins_pad), 1)
    edge_iota = jax.lax.broadcasted_iota(jnp.int32, (1, edges_pad), 1)

    def row_body(r, acc):
        rows = pl.ds(pl.multiple_of(r * row_block, row_block), row_block)
        a = [lane1_ref[t1, ch, rows] for ch in range(8)]  # each (R,)
        z1 = a[7]

        def select(col):
            # exact per-row selection of a table column by bin id
            value = jnp.zeros_like(z1)
            for b in range(num_bins):
                value = jnp.where(z1 == b, table_ref[b, col], value)
            return value[:, None]

        thresholds = [select(e) for e in range(num_edges)]
        params = [select(num_edges + c) for c in range(num_params)]
        x1 = [a[d][:, None] for d in range(6)]

        def col_body(c, sums):
            cols = pl.ds(pl.multiple_of(c * col_block, col_block), col_block)
            chord2 = None
            for dim in range(3):
                d_hi = x1[dim] - lane2_ref[t2, dim, cols][None, :]
                d_lo = x1[3 + dim] - lane2_ref[t2, 3 + dim, cols][None, :]
                d = d_hi + d_lo
                chord2 = d * d if chord2 is None else chord2 + d * d
            w_cols = lane2_ref[t2, 6, cols][None, :]
            if cols_binned:
                z_cols = lane2_ref[t2, 7, cols][None, :]
                w_eff = jnp.where(z1[:, None] == z_cols, w_cols, 0.0)
            else:
                w_eff = jnp.broadcast_to(w_cols, chord2.shape)
            if direct is not None:
                w_eff = apply_direct_weight(
                    chord2, params, w_eff,
                    num_sub=direct[0], num_below=direct[1],
                    num_above=direct[2],
                    small_angle=len(direct) > 3 and direct[3],
                )
            return tuple(
                s + jnp.sum(jnp.where(chord2 <= thr, w_eff, 0.0), axis=1)
                for s, thr in zip(sums, thresholds)
            )

        sums = jax.lax.fori_loop(
            0, tile_size // col_block, col_body,
            tuple(jnp.zeros_like(z1) for _ in range(num_edges)),
        )
        # fold rows into their bins, weighted by the row weights
        onehot = z1[:, None] == bin_iota  # (R, Bp)
        for e in range(num_edges):
            weighted = (a[6] * sums[e])[:, None]
            per_bin = jnp.sum(jnp.where(onehot, weighted, 0.0), axis=0)
            acc = acc + jnp.where(edge_iota == e, per_bin[:, None], 0.0)
        return acc

    zeros = jnp.zeros((bins_pad, edges_pad), jnp.float32)

    @pl.when(t1 >= 0)
    def _():
        out_ref[...] = jax.lax.fori_loop(
            0, tile_size // row_block, row_body, zeros
        )

    @pl.when(t1 < 0)
    def _():
        out_ref[...] = zeros


@lru_cache(maxsize=256)
def _build_kernel_call(
    num_pairs: int,
    tile_size: int,
    num_bins: int,
    num_table_cols: int,
    cols_binned: bool,
    direct: tuple | None,
    interpret: bool,
):
    """Construct (and cache) the pallas_call for one configuration."""
    if tile_size & (tile_size - 1):
        raise ValueError(
            f"the 'pallas' engine needs a power-of-two tile size, got "
            f"{tile_size}"
        )
    num_edges = counting_width(num_table_cols, direct)
    bins_pad, edges_pad = _pow2(num_bins), _pow2(num_edges)
    row_block, col_block, num_warps = BLOCKS[direct is not None]
    kernel = partial(
        _paircount_kernel,
        tile_size=tile_size,
        num_bins=num_bins,
        num_edges=num_edges,
        num_params=num_table_cols - num_edges,
        cols_binned=cols_binned,
        direct=direct,
        row_block=min(row_block, tile_size),
        col_block=min(col_block, tile_size),
    )
    return pl.pallas_call(
        kernel,
        grid=(num_pairs,),
        out_specs=pl.BlockSpec((None, bins_pad, edges_pad), lambda k: (k, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (num_pairs, bins_pad, edges_pad), jnp.float32
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="paircount_tiles",
    )


def pallas_partial_counts(
    lane_data1,
    lane_data2,
    tile1,
    tile2,
    slots,
    chord2_table,
    *,
    num_slots_out: int,
    cols_binned: bool,
    interpret: bool,
    direct: tuple | None = None,
) -> jnp.ndarray:
    """Traced core of the kernel engine over a padded pair list.

    Padding entries carry ``tile1 = -1`` (the program skips them and
    writes a zero block) and any slot id, conventionally the dump slot.
    ``slots`` must be non-decreasing. Returns ``(num_slots_out, B, E)``;
    slots that no pair visits come back exactly zero. Usable inside an
    outer ``jit`` or a per-device ``shard_map`` program."""
    num_bins, num_table_cols = chord2_table.shape
    num_edges = counting_width(num_table_cols, direct)
    call = _build_kernel_call(
        int(tile1.shape[0]),
        int(lane_data1.shape[2]),
        num_bins,
        num_table_cols,
        cols_binned,
        direct,
        interpret,
    )
    blocks = call(tile1, tile2, lane_data1, lane_data2, chord2_table)
    return jax.ops.segment_sum(
        blocks[:, :num_bins, :num_edges],
        slots,
        num_segments=num_slots_out,
        indices_are_sorted=True,
    )


@partial(
    jax.jit,
    static_argnames=("num_slots_out", "cols_binned", "interpret", "direct"),
)
def _partial_counts_stacked(
    lane_data1, lane_data2, stacked, chord2_table, **static
):
    """Entry taking the stacked ``(3, padded)`` index array, so the host
    pays one upload and one dispatch per call."""
    return pallas_partial_counts(
        lane_data1, lane_data2,
        stacked[0], stacked[1], stacked[2],
        chord2_table, **static,
    )


def count_pairs_pallas(
    lane_data1: jnp.ndarray,
    lane_data2: jnp.ndarray,
    pairs: TilePairs,
    chord2_table: jnp.ndarray,
    *,
    cols_binned: bool,
    interpret: bool = False,
    direct: tuple | None = None,
    padded_slots: bool = False,
) -> jnp.ndarray:
    """Run the kernel over a slot-sorted tile-pair list.

    Returns a float32 device array ``(num_slots, B, E)``. With
    ``padded_slots=True`` the full bucketed slot axis
    (``bucket_size(num_slots + 1)`` rows) is returned instead, so jitted
    consumers compile once per bucket; rows ``>= num_slots`` are zero.
    """
    check_kernel_backend(interpret)
    num_slots = pairs.num_slots
    num_slots_out = bucket_size(num_slots + 1, base=64)
    padded = bucket_size(pairs.num_pairs, base=512)

    # the padded index arrays go up once, stacked into a single transfer,
    # cached on the (memoised) pair list so warm repeats skip the upload
    cache_key = ("stacked", padded, num_slots)
    stacked = pairs._device_cache.get(cache_key)
    if stacked is None:
        tile1 = np.full(padded, -1, dtype=np.int32)
        tile2 = np.zeros(padded, dtype=np.int32)
        slots = np.full(padded, num_slots, dtype=np.int32)
        tile1[: pairs.num_pairs] = pairs.tile1
        tile2[: pairs.num_pairs] = pairs.tile2
        slots[: pairs.num_pairs] = pairs.slot
        stacked = jnp.asarray(np.stack([tile1, tile2, slots]))
        pairs._device_cache[cache_key] = stacked

    total = _partial_counts_stacked(
        lane_data1, lane_data2, stacked, chord2_table,
        num_slots_out=num_slots_out, cols_binned=cols_binned,
        interpret=interpret, direct=direct,
    )
    return total if padded_slots else total[:num_slots]
