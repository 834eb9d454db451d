"""Shard the tile-pair grid over a device mesh.

Design (see SURVEY.md section 2.2): the unit of distribution is the flat,
slot-sorted tile-pair list from
:func:`yet_another_wizz_tpu.ops.linkage.build_tile_pairs`. Each device
receives an equal, contiguous chunk (padded with dump-slot entries),
evaluates the same per-device pair-count engine as single-device
execution into its private ``(num_slots + 1, B, E)`` partial tensor, and
the partials are summed with ``psum`` over the mesh. Three catalog layouts
are implemented (``data_sharding=``): ``replicated`` tiles on every device,
``columns`` with the column catalog sharded 1/N, and ``ring`` with both
catalogs sharded 1/N and the row shard rotating between devices via
``ppermute``.

Multi-host pods: when more than one jax process participates
(``jax.process_count() > 1`` after
:func:`yet_another_wizz_tpu.parallel.initialize`), the same code runs over
the global device mesh — every process prepares the identical host-side
pair list deterministically and contributes the shards of its addressable
devices (``jax.make_array_from_callback``); the ``psum`` then crosses
hosts.
"""

from __future__ import annotations

import logging
from functools import lru_cache, partial
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from yet_another_wizz_tpu.ops.tiles import bucket_size

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu.ops.linkage import TilePairs
    from yet_another_wizz_tpu.ops.tiles import TileSet

__all__ = [
    "auto_mesh",
    "count_pairs_sharded",
    "default_mesh",
]

MESH_AXIS = "shards"

logger = logging.getLogger(__name__)

NUM_DEVICES_ENV = "YAWT_NUM_DEVICES"
"""Environment override for the automatic device pool: the number of
devices the engine uses when no explicit mesh is given (``1`` pins
single-device execution; on the CPU backend, where "devices" are virtual
slices of the same cores, setting it is the only way to opt in). The
moral equivalent of the reference's ``YAW_NUM_THREADS`` worker-pool
override (/root/reference/src/yaw/utils/parallel.py:53-85)."""


def default_mesh(num_devices: int | None = None) -> Mesh:
    """A 1-dim mesh over the available (or first ``num_devices``) devices.

    In a multi-process job ``jax.devices()`` lists the global devices of
    all processes, so the default mesh spans the full pod."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (MESH_AXIS,))


def auto_mesh() -> Mesh | None:
    """The device mesh an engine call should use when none was requested.

    Mirrors the reference, which automatically spreads over its full
    local worker pool (physical cores or ``YAW_NUM_THREADS``,
    /root/reference/src/yaw/utils/parallel.py:53-85): here the pool is
    the local accelerators, so a single-process job on a four-GPU host
    uses all four by default instead of one.

    Returns ``None`` (single-device execution) when only one device is
    available or ``YAWT_NUM_DEVICES=1``. Multi-process pod jobs always
    get the global mesh: all processes were launched to participate. On
    the CPU backend the automatic pool stays disabled unless
    ``YAWT_NUM_DEVICES`` asks for it — virtual CPU "devices" are slices
    of the same physical cores, so sharding over them buys no hardware
    (the reference counts physical cores for the same reason).
    """
    import os

    if jax.process_count() > 1:
        return default_mesh()

    env = os.environ.get(NUM_DEVICES_ENV, "").strip()
    num_devices = None
    if env:
        try:
            num_devices = int(env)
        except ValueError:
            # a broken tuning knob must not abort a measurement (same
            # policy as YAWT_RESIDENT_TILE_BYTES / YAWT_NUM_THREADS)
            logger.warning(
                "ignoring malformed %s=%r", NUM_DEVICES_ENV, env
            )
        else:
            if num_devices <= 1:
                return None
    if num_devices is None and jax.default_backend() == "cpu":
        # without an explicit (valid) opt-in, virtual CPU "devices" are
        # slices of the same cores — no automatic pool
        return None

    available = len(jax.devices())
    if num_devices is not None:
        num_devices = min(num_devices, available)
        if num_devices <= 1:
            # e.g. YAWT_NUM_DEVICES=8 on a one-device host: a 1-device
            # mesh would pay shard_map/psum overhead for no parallelism
            return None
    elif available <= 1:
        return None
    return default_mesh(num_devices)


def _put_global(arr, sharding: NamedSharding):
    """Place a host array with the given sharding. Single-process jobs use
    a plain transfer; in multi-process jobs every process holds the same
    full host array (deterministic replicated prep) and contributes only
    the shards of its addressable devices."""
    if jax.process_count() > 1:
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )
    return jax.device_put(arr, sharding)


def _place_lanes(host, sharding: NamedSharding):
    """Place a :class:`~yet_another_wizz_tpu.ops.tiles.HostLanes` payload
    onto the mesh. Fixed-point payloads cross the link packed (17 B/point,
    less the elided uniform-weight / zero-bin lanes — see
    ``TileSet.host_lanes``)
    and expand to the engine's float32 layout through the jitted decode;
    the decode is elementwise over the tile axis, so jit propagates the
    input sharding to the output without any resharding."""
    if host.encoding == "float":
        return _put_global(host.data, sharding)
    from yet_another_wizz_tpu.ops.tiles import decode_fixedpoint_lanes

    return decode_fixedpoint_lanes()(
        _put_global(host.data, sharding),
        _put_global(host.params, sharding),
        _put_global(host.zbins, sharding),
    )


def _fetch_replicated(result) -> np.ndarray:
    """Bring a fully-replicated global result to the host (works for both
    single- and multi-process jobs: every process holds a full copy)."""
    if jax.process_count() > 1:
        return np.asarray(result.addressable_data(0))
    return np.asarray(jax.device_get(result))


def _pad_chunk_length(n: int, chunk_size: int) -> int:
    """Common padded per-device pair-list length for both engines:
    bucketed for compile reuse and a chunk multiple for the XLA scan."""
    return bucket_size(n, base=chunk_size, multiple_of=chunk_size)


def _partial_counts(
    lane1, lane2, tile1, tile2, slots, table,
    *,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    engine: str = "xla",
    interpret: bool = False,
    direct: tuple | None = None,
):
    """Per-device counts over the local chunk of the pair list.

    ``engine="pallas"`` runs the GPU kernel of
    :mod:`yet_another_wizz_tpu.ops.pallas_paircount` on the shard (the
    same code path as single-device execution); ``engine="xla"``
    scatter-adds through the portable vmap+scan program. The output slot
    axis is padded to ``num_slots_out`` (bucketed) so the compiled
    program is reused across patch linkages; dump/pad slots are sliced
    off by the caller."""
    if engine == "pallas":
        from yet_another_wizz_tpu.ops.pallas_paircount import (
            pallas_partial_counts,
        )

        return pallas_partial_counts(
            lane1, lane2, tile1, tile2, slots, table,
            num_slots_out=num_slots_out,
            cols_binned=cols_binned,
            interpret=interpret,
            direct=direct,
        )
    return _partial_counts_xla(
        lane1, lane2, tile1, tile2, slots, table,
        cols_binned=cols_binned,
        num_slots_out=num_slots_out,
        chunk_size=chunk_size,
        direct=direct,
    )


def _partial_counts_xla(
    lane1, lane2, tile1, tile2, slots, table,
    *,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    direct: tuple | None = None,
):
    """XLA scatter-add engine: the shared scan core with the carry marked
    device-varying over the shard_map axis."""
    from yet_another_wizz_tpu.ops.paircount import scan_scatter_counts

    return scan_scatter_counts(
        lane1, lane2, tile1, tile2, slots, table,
        cols_binned=cols_binned, num_slots_out=num_slots_out,
        chunk_size=chunk_size, direct=direct, axis_name=MESH_AXIS,
    )


def count_pairs_sharded(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    chord2_table: NDArray,
    *,
    mesh: Mesh | None = None,
    chunk_size: int | None = None,
    data_sharding: str = "replicated",
    engine: str = "auto",
    defer: bool = False,
    direct: tuple | None = None,
    interpret: bool = False,
) -> NDArray:
    """Multi-device pair counting over a mesh; same result contract as
    :func:`yet_another_wizz_tpu.ops.paircount.count_pairs_tiles`.

    ``engine`` selects the per-device compute program: ``pallas`` (the
    GPU kernel; ``interpret=True`` runs it in the Pallas interpreter),
    ``xla`` (portable vmap+scan scatter-add), or ``auto`` (see
    :func:`yet_another_wizz_tpu.ops.paircount.resolve_backend`).

    With ``defer=True`` (single-process jobs only) the replicated device
    result is returned WITHOUT fetching it, so queued follow-up counts
    overlap the transfer; the caller fetches via ``jax.device_get``.

    ``data_sharding`` selects the distribution of the catalog tiles:

    - ``"replicated"``: both tile sets on every device; the pair list is
      split into equal contiguous chunks. Simplest; memory per device is
      the full catalog pair.
    - ``"columns"``: the column catalog's tiles are sharded over the mesh
      (device d owns a contiguous tile range) and each device processes
      exactly the pairs whose column tile it owns — no tile communication
      at all, only the final ``psum``. Per-device memory for the (usually
      much larger) column side scales as 1/num_devices; the natural
      layout for randoms catalogs on pods.
    - ``"ring"``: BOTH catalogs sharded 1/num_devices. Column shards stay
      pinned; the row shard rotates one hop around the device ring per step
      (``ppermute``), so after num_devices steps every (row shard, column
      shard) combination has met exactly once on some device. The compute
      of step s+1 overlaps the ring transfer of step s in XLA's schedule;
      per-device memory for both catalogs scales as 1/num_devices — the
      layout for survey-scale inputs that fit on no single device.
    """
    mesh = mesh or default_mesh()
    num_devices = mesh.devices.size
    num_slots = pairs.num_slots
    num_slots_out = bucket_size(num_slots + 1, base=64)
    cols_binned = tiles2.binned
    from yet_another_wizz_tpu.ops.paircount import CHUNK_SIZE, resolve_backend

    chunk_size = chunk_size or CHUNK_SIZE

    engine = resolve_backend(engine, interpret, direct)

    table = jnp.asarray(chord2_table, dtype=jnp.float32)
    if pairs.num_pairs == 0:
        # same result contract as count_pairs_tiles: in direct mode the
        # edge axis covers only the COUNTING columns, not the combined
        # table's parameter columns (ops/paircount.py:570-573)
        from yet_another_wizz_tpu.ops.gweight import counting_width

        width = counting_width(table.shape[1], direct)
        return np.zeros(
            (num_slots, table.shape[0], width), dtype=np.float64
        )

    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(MESH_AXIS))

    if data_sharding == "columns":
        # device d owns the logical column-tile range
        # [d * logical, (d + 1) * logical); its lane block is padded to the
        # bucketed shard size for shape-stable compiles. Ownership uses the
        # LOGICAL split so work stays balanced over all devices (bucketed
        # ownership would concentrate tiles on the first devices).
        lane2_host, logical, _ = _shard_host_lanes(
            tiles2.host_lanes(), num_devices
        )
        owner = np.minimum(pairs.tile2 // logical, num_devices - 1)

        # partition the pair list by owner, keep slot-sorted order within
        # each partition, pad every partition to the common chunked length
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=num_devices)
        longest = _pad_chunk_length(int(counts.max()), chunk_size)

        tile1 = np.full(num_devices * longest, -1, dtype=np.int32)
        tile2 = np.zeros(num_devices * longest, dtype=np.int32)
        slots = np.full(num_devices * longest, num_slots, dtype=np.int32)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        for device in range(num_devices):
            sel = order[bounds[device] : bounds[device + 1]]
            base = device * longest
            tile1[base : base + len(sel)] = pairs.tile1[sel]
            # local column-tile indices within the device's logical range
            tile2[base : base + len(sel)] = (
                pairs.tile2[sel] - device * logical
            )
            slots[base : base + len(sel)] = pairs.slot[sel]
        # padding entries index row tile -1 (skipped by the kernel; the
        # XLA engine wraps it to a real tile) and the dump slot

        lane1 = _place_lanes(tiles1.host_lanes(), replicated)
        lane2 = _place_lanes(lane2_host, sharded)
    elif data_sharding == "ring":
        return _count_pairs_ring(
            tiles1, tiles2, pairs, table,
            mesh=mesh, chunk_size=chunk_size,
            cols_binned=cols_binned, num_slots=num_slots,
            engine=engine, interpret=interpret, defer=defer,
            direct=direct,
        )
    elif data_sharding == "replicated":
        # equal contiguous chunks of the slot-sorted pair list; the
        # per-device length is bucketed for shape-stable compiles
        per_device = _pad_chunk_length(
            -(-pairs.num_pairs // num_devices), chunk_size
        )
        padded = num_devices * per_device
        tile1 = np.full(padded, -1, dtype=np.int32)
        tile2 = np.zeros(padded, dtype=np.int32)
        slots = np.full(padded, num_slots, dtype=np.int32)
        tile1[: pairs.num_pairs] = pairs.tile1
        tile2[: pairs.num_pairs] = pairs.tile2
        slots[: pairs.num_pairs] = pairs.slot

        lane1 = _place_lanes(tiles1.host_lanes(), replicated)
        lane2 = _place_lanes(tiles2.host_lanes(), replicated)
    else:
        raise ValueError(f"unknown data_sharding '{data_sharding}'")

    table = _put_global(table, replicated)
    tile1 = _put_global(tile1, sharded)
    tile2 = _put_global(tile2, sharded)
    slots = _put_global(slots, sharded)

    sharded_counts = _sharded_counts_fn(
        mesh, data_sharding == "columns", cols_binned, num_slots_out,
        chunk_size, engine, interpret, direct,
    )
    result = sharded_counts(lane1, lane2, tile1, tile2, slots, table)
    return _finish_counts(result, num_slots, defer)


def _finish_counts(result, num_slots: int, defer: bool):
    '''Slice off dump/pad slots; with ``defer`` (single-process) hand the
    in-flight device array back without waiting for it.'''
    if defer and jax.process_count() == 1:
        return result[:num_slots]
    return _fetch_replicated(result).astype(np.float64)[:num_slots]


@lru_cache(maxsize=64)
def _sharded_counts_fn(
    mesh: Mesh,
    lane2_sharded: bool,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    engine: str = "xla",
    interpret: bool = False,
    direct: tuple | None = None,
):
    """Build (and cache) the jitted shard_map program for one sharded
    configuration: a fresh closure per call would miss jax's trace cache
    and pay a full retrace/compile for every count of every measurement
    (compiles cost seconds to minutes at survey scale)."""
    lane2_spec = P(MESH_AXIS) if lane2_sharded else P()

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), lane2_spec, P(MESH_AXIS), P(MESH_AXIS), P(MESH_AXIS), P()
        ),
        out_specs=P(),
        # pallas_call outputs carry no mesh-axis varying-ness, and the
        # Pallas interpreter cannot type it either
        check_vma=(engine != "pallas"),
    )
    def sharded_counts(lane1, lane2, tile1, tile2, slots, table):
        local = _partial_counts(
            lane1, lane2, tile1, tile2, slots, table,
            cols_binned=cols_binned,
            num_slots_out=num_slots_out,
            chunk_size=chunk_size,
            engine=engine,
            interpret=interpret,
            direct=direct,
        )
        return jax.lax.psum(local, MESH_AXIS)

    return sharded_counts


def _shard_tiles(lane_data, num_devices):
    """Split tiles into equal LOGICAL per-device ranges and pad each
    device's lane block to a common bucketed size.

    Device ``d`` owns tiles ``[d * logical, (d + 1) * logical)`` at local
    offsets ``0..`` of its block; the block size is bucketed for
    shape-stable compiles without skewing ownership (bucketing the
    ownership stride itself would put all tiles on the first devices and
    idle the rest)."""
    num_tiles = len(lane_data)
    logical = max(1, -(-num_tiles // num_devices))
    shard = bucket_size(logical, base=64)
    blocks = np.zeros(
        (num_devices * shard, *lane_data.shape[1:]), dtype=lane_data.dtype
    )
    for device in range(num_devices):
        chunk = lane_data[device * logical : (device + 1) * logical]
        blocks[device * shard : device * shard + len(chunk)] = chunk
    return blocks, logical, shard


def _shard_host_lanes(host, num_devices):
    """Apply :func:`_shard_tiles` to a HostLanes payload: the decode
    parameters are split and padded identically to the lane blocks, so
    per-device decode stays aligned (zero-padded tiles decode to zero
    lanes with zero weights)."""
    data, logical, shard = _shard_tiles(host.data, num_devices)
    params = zbins = None
    if host.params is not None:
        params, _, _ = _shard_tiles(host.params, num_devices)
    if host.zbins is not None:
        zbins, _, _ = _shard_tiles(host.zbins, num_devices)
    return type(host)(host.encoding, data, params, zbins), logical, shard


def _reshape_host_lanes(host, num_devices, shard):
    """Reshape a sharded HostLanes payload to an explicit leading device
    axis (the ring layout's block form)."""
    data = host.data.reshape(num_devices, shard, *host.data.shape[1:])
    params = zbins = None
    if host.params is not None:
        params = host.params.reshape(
            num_devices, shard, *host.params.shape[1:]
        )
    if host.zbins is not None:
        zbins = host.zbins.reshape(
            num_devices, shard, *host.zbins.shape[1:]
        )
    return type(host)(host.encoding, data, params, zbins)


def _count_pairs_ring(
    tiles1, tiles2, pairs, table,
    *,
    mesh, chunk_size, cols_binned, num_slots,
    engine="xla", interpret=False, defer=False, direct=None,
):
    """Both-sides-sharded execution: column shards pinned per device, the
    row shard rotates around the ring; device d at step s processes the
    pairs whose column tile it owns and whose row tile lives in the shard
    currently resident, i.e. shard ``(d - s) mod N``."""
    num_devices = mesh.devices.size

    num_slots_out = bucket_size(num_slots + 1, base=64)
    lane1_host, logical1, shard1 = _shard_host_lanes(
        tiles1.host_lanes(), num_devices
    )
    lane2_host, logical2, shard2 = _shard_host_lanes(
        tiles2.host_lanes(), num_devices
    )

    owner1 = np.minimum(pairs.tile1 // logical1, num_devices - 1)
    owner2 = np.minimum(pairs.tile2 // logical2, num_devices - 1)
    step_of_pair = (owner2 - owner1) % num_devices  # met at this ring step

    # bucket pairs by (device, step); pad all buckets to a common chunked
    # length with dump-slot entries (row tile -1, as in the other layouts)
    key = owner2 * num_devices + step_of_pair
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_devices * num_devices)
    longest = _pad_chunk_length(max(int(counts.max()), 1), chunk_size)

    shape = (num_devices, num_devices, longest)
    tile1 = np.full(shape, -1, dtype=np.int32)
    tile2 = np.zeros(shape, dtype=np.int32)
    slots = np.full(shape, num_slots, dtype=np.int32)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for device in range(num_devices):
        for step in range(num_devices):
            bucket = device * num_devices + step
            sel = order[bounds[bucket] : bounds[bucket + 1]]
            n = len(sel)
            # local indices within the resident row shard / owned col shard
            row_shard = (device - step) % num_devices
            tile1[device, step, :n] = (
                pairs.tile1[sel] - row_shard * logical1
            )
            tile2[device, step, :n] = (
                pairs.tile2[sel] - device * logical2
            )
            slots[device, step, :n] = pairs.slot[sel]

    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(MESH_AXIS))
    lane1 = _place_lanes(
        _reshape_host_lanes(lane1_host, num_devices, shard1), sharded
    )
    lane2 = _place_lanes(
        _reshape_host_lanes(lane2_host, num_devices, shard2), sharded
    )
    table = _put_global(table, replicated)
    tile1 = _put_global(tile1, sharded)
    tile2 = _put_global(tile2, sharded)
    slots = _put_global(slots, sharded)

    ring_counts = _ring_counts_fn(
        mesh, cols_binned, num_slots_out, chunk_size, engine, interpret,
        direct,
    )
    result = ring_counts(lane1, lane2, tile1, tile2, slots, table)
    return _finish_counts(result, num_slots, defer)


@lru_cache(maxsize=64)
def _ring_counts_fn(
    mesh: Mesh,
    cols_binned: bool,
    num_slots_out: int,
    chunk_size: int,
    engine: str = "xla",
    interpret: bool = False,
    direct: tuple | None = None,
):
    """Build (and cache) the jitted ring program for one configuration
    (see :func:`_sharded_counts_fn` for the retrace rationale)."""
    num_devices = mesh.devices.size
    perm = [(i, (i + 1) % num_devices) for i in range(num_devices)]

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(MESH_AXIS), P(MESH_AXIS), P(MESH_AXIS), P(MESH_AXIS),
            P(MESH_AXIS), P(),
        ),
        out_specs=P(),
        # see _sharded_counts_fn
        check_vma=(engine != "pallas"),
    )
    def ring_counts(lane1, lane2, tile1, tile2, slots, table):
        # leading mesh axis is size 1 inside the shard
        lane1_resident = lane1[0]
        lane2_local = lane2[0]

        def step(carry, step_data):
            resident, acc = carry
            idx1, idx2, slot = step_data
            partial_acc = _partial_counts(
                resident, lane2_local, idx1, idx2, slot, table,
                cols_binned=cols_binned,
                num_slots_out=num_slots_out,
                chunk_size=chunk_size,
                engine=engine,
                interpret=interpret,
                direct=direct,
            )
            acc = acc + partial_acc
            # rotate the row shard one hop around the ring
            resident = jax.lax.ppermute(resident, MESH_AXIS, perm)
            return (resident, acc), None

        from yet_another_wizz_tpu.ops.gweight import counting_width

        init_acc = jnp.zeros(
            (
                num_slots_out,
                table.shape[0],
                counting_width(table.shape[1], direct),
            ),
            dtype=jnp.float32,
        )
        init_acc = jax.lax.pcast(init_acc, to="varying", axis_name=MESH_AXIS)
        # xs leading axis = ring steps; each step consumes a flat padded
        # pair list which _partial_counts chunks internally
        (_, acc), _ = jax.lax.scan(
            step,
            (lane1_resident, init_acc),
            (tile1[0], tile2[0], slots[0]),
        )
        return jax.lax.psum(acc, MESH_AXIS)

    return ring_counts
