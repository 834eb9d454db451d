"""Device-memory-bounded pair counting over patch blocks.

At survey scale the packed tile arrays of a catalog exceed device memory
(32 bytes/point; ~32 GB per 10^9 points, against the 80 GB of an H100 of
which JAX takes three quarters). The blocked path streams the
measurement through the device in patch blocks:

- patches are processed in contiguous blocks of ``max_resident_patches``;
- for every linked pair of blocks, tile sets are built for just those
  patches (native packing) and pushed through the regular engine;
- per-block count tensors scatter into the global
  ``(scale, bin, patch, patch)`` result on the host.

This mirrors the reference's bounded working set ("2 patches + tree
overhead per worker", reference docs ``concepts.rst:11-16``) at block
granularity, and composes with the mesh sharding over several devices.

Enabled through ``max_resident_patches`` on the measurement functions.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu.ops.linkage import build_tile_pairs
from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu.ops.tiles import build_tile_set

if TYPE_CHECKING:
    from yet_another_wizz_tpu.binning import Binning
    from yet_another_wizz_tpu.catalog.catalog import Catalog
    from yet_another_wizz_tpu.ops.linkage import Linkage
    from yet_another_wizz_tpu.ops.thresholds import AngularEdges

__all__ = [
    "active_tile_cache",
    "count_pairs_blocked",
    "measurement_tile_cache",
]

logger = logging.getLogger(__name__)


def _build_block_tiles(
    catalog: Catalog,
    binning: Binning | None,
    mode: str,
    patch_lo: int,
    patch_hi: int,
    tile_size: int,
    layout: str = "spatial",
):
    """Tile set for the patches in ``[patch_lo, patch_hi)`` with local
    patch indices.

    Data access goes through ``catalog.load_block`` so both the in-memory
    :class:`Catalog` and the disk-backed
    :class:`~yet_another_wizz_tpu.catalog.lazy.LazyCatalog` (whose host
    memory stays bounded at one resident block) can drive the blocked
    engine."""
    data = catalog.load_block(patch_lo, patch_hi)
    local_weights = data.weights
    local_kappa = data.kappa

    if mode == "k":
        if local_kappa is None:
            raise ValueError("missing required 'kappa' for scalar mode")
        mode_weights = (
            local_kappa if local_weights is None
            else local_kappa * local_weights
        )
    elif mode == "n":
        mode_weights = None
    else:
        # same validation as the in-memory Catalog.get_tiles: a typo'd
        # mode must raise, not silently count number weights
        raise ValueError(f"invalid counting mode '{mode}'")

    if binning is None:
        zbins, num_bins = None, 0
    else:
        if data.redshifts is None:
            raise ValueError("catalog has no 'redshifts' attached")
        zbins = binning.digitize(data.redshifts) - 1
        num_bins = len(binning)

    return build_tile_set(
        data.xyz,
        data.patch_ids,
        patch_hi - patch_lo,
        weights=local_weights,
        zbins=zbins,
        num_bins=num_bins,
        kappa=local_kappa,
        tile_size=tile_size,
        mode_weights=mode_weights,
        layout=layout if binning is not None else "spatial",
        device_pad_base=64,  # tight upload padding, see TileSet docs
    )


class _WeakId:
    """Hashable weak-identity token for cache keys.

    Catalogs are Mappings (unhashable), so ``weakref.ref`` cannot key a
    dict directly. Tokens of the same LIVE object compare equal (hash =
    the object's id); once the referent is garbage-collected a token
    only equals itself — a new object reusing the freed id hashes into
    the same bucket but never compares equal, so stale entries cannot be
    served and are reclaimed by :meth:`_ColumnTileCache._purge_dead`."""

    __slots__ = ("_ref", "_id")

    def __init__(self, obj) -> None:
        import weakref

        self._ref = weakref.ref(obj)
        self._id = id(obj)

    def __hash__(self) -> int:
        return self._id

    def __eq__(self, other) -> bool:
        if not isinstance(other, _WeakId):
            return NotImplemented
        mine, theirs = self._ref(), other._ref()
        if mine is None or theirs is None:
            return self._ref is other._ref
        return mine is theirs

    @property
    def dead(self) -> bool:
        return self._ref() is None


from yet_another_wizz_tpu.catalog.tilestore import (
    TILE_SET_ARRAYS as _TILE_SET_ARRAYS,
    tileset_from_payload as _tileset_from_payload,
    tileset_payload as _tileset_payload,
)


class _ColumnTileCache:
    """Per-measurement cache of packed column-block tile sets.

    The blocked loop sweeps every column block once per ROW block; without
    a cache each sweep re-reads the patch data and re-packs the tiles
    (Morton sort + native scatter), i.e. O(num_blocks^2) packing work for
    data that only changes per measurement, and re-uploads the packed
    lanes through the host-device link. Two bounded layers:

    - **resident** (``resident_bytes`` of budget, accounted in
      device-padded lane bytes): the :class:`TileSet` objects themselves
      are kept alive, so their cached device arrays
      (:meth:`TileSet.device_data`) stay in HBM and every revisit skips
      BOTH the packing and the upload, so the blocked path streams each
      column block to the device once per measurement instead of once per
      row sweep. Host memory holds the
      same lane bytes (the TileSet's numpy arrays) — the budget bounds
      both sides. (Under mesh-sharded execution the engine places lanes
      per call with its own shardings, so this layer then saves the
      packing but not the transfer.)
    - **disk spill**: blocks beyond the resident budget go to an
      uncompressed ``.npz`` per column block (capped at ``max_bytes``),
      turning a revisit into a sequential file read + one upload while
      keeping host memory bounded at one resident block pair.

    Blocks beyond both budgets are simply rebuilt each sweep. Within one
    count, no eviction of its own entries: the sweep order revisits
    blocks uniformly, so evicting one block to admit another buys
    nothing. Across counts (generations, see :meth:`begin_count`)
    stale entries ARE evicted under budget pressure, oldest generation
    first — a session-long cache must not let one measurement's blocks
    permanently starve later measurements of their (load-bearing)
    within-count caching. Entries whose weakly-keyed catalog has been
    freed can never be hit again and are purged eagerly (with their
    budget bytes and spill files). The cache lives
    for the duration of one :func:`count_pairs_blocked` call — or, via
    :func:`measurement_tile_cache`, for a whole measurement, sharing
    blocks between its count types (e.g. DD and RD of a
    cross-correlation both stream the unknown catalog as columns; DD
    and DR share the reference as rows). Entries are keyed by
    ``(catalog, binning, mode, layout, block size, block index)``, so
    only genuinely identical tile sets are shared.

    ``store_rows=True`` (set by :func:`measurement_tile_cache`) also
    admits ROW blocks: within one count rows are visited once each, but
    across the counts of a measurement the same catalog often returns
    as the row side. Per-call caches leave rows out so one-shot row
    blocks cannot crowd the column blocks out of the budgets.
    """

    def __init__(
        self,
        directory: str | None,
        max_bytes: int,
        resident_bytes: int = 0,
        store_rows: bool = False,
    ) -> None:
        import threading

        self._dir = directory
        self._max_bytes = max_bytes if directory is not None else 0
        self._used = 0
        self._paths: dict[object, tuple[str, int]] = {}
        self._resident_bytes = resident_bytes
        self._resident_used = 0
        self._resident: dict[object, object] = {}
        self._stats_lock = threading.Lock()
        self._mutate_lock = threading.Lock()  # store/purge serialisation
        self._stored = 0  # monotonic: unique spill file names
        self.store_rows = store_rows
        self.hits = 0
        self.misses = 0
        self.generation = 0
        self._gen: dict[object, int] = {}  # last use per entry
        self._active: set[int] = set()  # generations of RUNNING counts

    def begin_count(self) -> int:
        """Mark the start of a new count (thread-safe); returns a token
        for :meth:`end_count`.

        Entries last used before the oldest still-RUNNING count began
        become evictable under budget pressure: a session-long cache
        whose budgets fill with one measurement's blocks must not starve
        every later measurement of caching (the within-count column
        reuse is the load-bearing layer — without it each row sweep
        re-packs every column block). Entries touched since any running
        count began are never evicted — the sweep revisits them
        uniformly, so evicting one to admit another buys nothing, and
        the floor is the OLDEST active generation so an ambient cache
        shared by concurrent measurements (user threads) cannot have one
        thread's new count flush another thread's in-flight blocks."""
        with self._mutate_lock:
            self.generation += 1
            self._active.add(self.generation)
            self._purge_dead()
            return self.generation

    def end_count(self, token: int) -> None:
        """Retire a running count's generation (see :meth:`begin_count`)."""
        with self._mutate_lock:
            self._active.discard(token)

    def _eviction_floor(self) -> int:
        """Entries last used before this generation are evictable."""
        return min(self._active) if self._active else self.generation

    def purge_dead(self) -> None:
        """Drop entries whose keyed catalog has been garbage-collected
        (thread-safe wrapper; see :meth:`_purge_dead`)."""
        with self._mutate_lock:
            self._purge_dead()

    def _evict_stale(self, layer: dict, needed: int, budget_left) -> None:
        """Evict stale entries (oldest first, see :meth:`begin_count`)
        from one cache layer until ``needed`` bytes fit or none remain.
        Never evicts at all when ``needed`` cannot fit even after
        flushing EVERY stale entry — an oversized block must not wipe
        blocks that later sweeps would have reused, for zero benefit.
        Caller holds ``_mutate_lock``."""
        import os

        floor = self._eviction_floor()
        stale = sorted(
            (key for key in layer if self._gen.get(key, 0) < floor),
            key=lambda key: self._gen.get(key, 0),
        )
        reclaimable = sum(
            self._device_nbytes(layer[key])
            if layer is self._resident
            else layer[key][1]
            for key in stale
        )
        if budget_left() + reclaimable < needed:
            return
        for key in stale:
            if budget_left() >= needed:
                return
            entry = layer.pop(key)
            self._gen.pop(key, None)
            if layer is self._resident:
                self._resident_used -= self._device_nbytes(entry)
            else:
                path, size = entry
                self._used -= size
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _purge_dead(self) -> None:
        """Drop entries whose keyed catalog has been garbage-collected.

        Keys lead with a weak identity token for the catalog: a dead
        referent can never match a future lookup (a new catalog is a new
        object, and dead tokens only equal themselves), so these entries
        are pure budget waste — including HBM held by resident device
        arrays. Called under budget pressure in store() and at the start
        of every blocked count (so a session cache does not retain the
        blocks of freed catalogs indefinitely once no further stores
        happen). Caller must hold ``_mutate_lock``."""
        import os

        def dead(key) -> bool:
            return (
                isinstance(key, tuple)
                and key
                and isinstance(key[0], _WeakId)
                and key[0].dead
            )

        for key in [k for k in self._resident if dead(k)]:
            self._resident_used -= self._device_nbytes(
                self._resident.pop(key)
            )
            self._gen.pop(key, None)
        for key in [k for k in self._paths if dead(k)]:
            path, size = self._paths.pop(key)
            self._used -= size
            self._gen.pop(key, None)
            try:
                os.unlink(path)
            except OSError:
                pass
        # load() stamps _gen outside _mutate_lock, so a stamp can land
        # just after an eviction popped the entry: sweep stamps that no
        # longer correspond to a live entry (else a session-long cache
        # accumulates dead key tuples indefinitely)
        for key in [
            k
            for k in self._gen
            if k not in self._resident and k not in self._paths
        ]:
            del self._gen[key]

    @staticmethod
    def _device_nbytes(tiles) -> int:
        """HBM bytes of the tile set's device array (padded lane data)."""
        from yet_another_wizz_tpu.ops.tiles import bucket_size

        padded = bucket_size(tiles.num_tiles, base=tiles.device_pad_base)
        return padded * int(np.prod(tiles.lane_data.shape[1:])) * 4

    def load(self, key, count: bool = True, resident_only: bool = False):
        """Fetch a cached tile set (None on miss). ``count=False`` leaves
        the hit/miss statistics alone — used for twin re-checks that are
        bookkeeping, not packing work (the counters are asserted on by
        tests as a proxy for how many blocks were actually packed).
        ``resident_only=True`` skips the disk layer: a deserialization +
        re-upload is never cheaper than tiles the caller already holds."""
        tiles = self._resident.get(key)
        if tiles is not None:
            self._gen[key] = self.generation  # atomic dict write
            if count:
                with self._stats_lock:  # loads run on prefetch threads
                    self.hits += 1
            return tiles
        entry = None if resident_only else self._paths.get(key)
        if entry is None:
            if count:
                with self._stats_lock:
                    self.misses += 1
            return None
        path, _ = entry
        try:
            with np.load(path) as payload:
                tiles = _tileset_from_payload(payload)
        except FileNotFoundError:
            # a concurrent stale-eviction unlinked the spill between the
            # dict read and the open: treat as a miss (the caller rebuilds)
            if count:
                with self._stats_lock:
                    self.misses += 1
            return None
        self._gen[key] = self.generation
        if count:
            with self._stats_lock:
                self.hits += 1
        # promote a disk hit into the resident layer when there is room:
        # without promotion a key that ever spilled stays disk-tier for
        # the rest of the session even after the resident budget frees
        # up, paying deserialize + re-upload on every later revisit
        import os

        with self._mutate_lock:
            if key in self._paths and self._admit_resident(key, tiles):
                path, size = self._paths.pop(key)
                self._used -= size
                try:
                    os.unlink(path)
                except OSError:
                    pass
        return tiles

    def store(self, key, tiles) -> None:
        import os

        # one mutation at a time: an ambient cache may be shared by
        # concurrent measurements (user threads), and the budget
        # accounting plus the purge are read-modify-write sequences
        with self._mutate_lock:
            self._store_locked(key, tiles, os)

    def _admit_resident(self, key, tiles) -> bool:
        """Try to admit a tile set into the resident layer (evicting
        stale entries if required). Caller holds ``_mutate_lock``."""
        if key in self._resident:
            return False
        dev_size = self._device_nbytes(tiles)
        if self._resident_used + dev_size > self._resident_bytes:
            self._purge_dead()  # reclaim entries of freed catalogs
            self._evict_stale(  # then stale generations, oldest first
                self._resident, dev_size,
                lambda: self._resident_bytes - self._resident_used,
            )
        if self._resident_used + dev_size <= self._resident_bytes:
            self._resident[key] = tiles
            self._resident_used += dev_size
            self._gen[key] = self.generation
            return True
        return False

    def _store_locked(self, key, tiles, os) -> None:
        if key in self._resident or key in self._paths:
            # duplicate store (e.g. a prefetched row block that is also a
            # column block of an autocorrelation-shaped count): keep the
            # first entry, avoid double-counting the budgets
            return
        if self._admit_resident(key, tiles):
            return

        size = sum(  # arrays only; scalars are negligible
            getattr(tiles, name).nbytes for name in _TILE_SET_ARRAYS
        )
        if tiles.sum_kappa is not None:
            size += tiles.sum_kappa.nbytes
        if self._dir is None:
            return
        if self._used + size > self._max_bytes:
            self._evict_stale(
                self._paths, size, lambda: self._max_bytes - self._used
            )
        if self._used + size > self._max_bytes:
            return
        payload = _tileset_payload(tiles)
        self._stored += 1  # len(_paths) shrinks on purge: not name-safe
        path = os.path.join(self._dir, f"block_{self._stored}.npz")
        try:
            np.savez(path, **payload)
        except OSError as err:
            # a failed spill write (ENOSPC — e.g. a tmpfs /tmp, see
            # _make_tile_cache) must degrade to an uncached sweep, not
            # abort hours of queued measurement work; disable the disk
            # layer so every later block does not retry the full write
            logger.warning(
                "disabling tile spill cache: write failed (%s)", err
            )
            self._dir = None
            try:
                os.unlink(path)  # reclaim the partial file now
            except OSError:
                pass
            return
        self._paths[key] = (path, size)
        self._used += size
        self._gen[key] = self.generation


def _resolve_resident_bytes(resident_tile_bytes: int | None) -> int:
    if resident_tile_bytes is None:
        import os

        env = os.environ.get("YAWT_RESIDENT_TILE_BYTES")
        try:
            # malformed values (e.g. "4GB") degrade to the default: a
            # broken tuning knob must not abort a measurement
            resident_tile_bytes = int(env) if env and env.strip() else None
        except ValueError:
            logger.warning(
                "ignoring malformed YAWT_RESIDENT_TILE_BYTES=%r", env
            )
            resident_tile_bytes = None
        if resident_tile_bytes is None:
            resident_tile_bytes = 4 << 30
    return resident_tile_bytes


def _make_tile_cache(
    stack: contextlib.ExitStack,
    tile_cache_bytes: int,
    resident_tile_bytes: int,
    *,
    store_rows: bool = False,
) -> _ColumnTileCache:
    """Construct a tile cache, registering its spill directory on the
    caller's exit stack. Spill location: ``YAWT_SPILL_DIR``, else the
    system temp dir. CAUTION for operators: on hosts where /tmp is tmpfs
    the spill is RAM-backed and competes with the bounded-memory goal of
    the blocked path — point ``YAWT_SPILL_DIR`` at real disk (e.g. next
    to the catalog caches) in that case."""
    import os
    import tempfile

    cache_dir = None
    if tile_cache_bytes > 0:
        spill_root = os.environ.get("YAWT_SPILL_DIR") or None
        cache_dir = stack.enter_context(
            tempfile.TemporaryDirectory(
                prefix="yawt_blocked_tiles_", dir=spill_root
            )
        )
    return _ColumnTileCache(
        cache_dir, tile_cache_bytes, resident_tile_bytes,
        store_rows=store_rows,
    )


# a ContextVar (not a process-global list) so the ambient scoping follows
# the context that opened the cache: a cache opened in one thread must not
# become the ambient cache — one shared budget and spill directory — for
# unrelated measurements running concurrently in other threads (same
# rationale as cli/directory.py's _CATALOG_MEMO)
_ACTIVE_CACHES: contextvars.ContextVar[tuple[_ColumnTileCache, ...]] = (
    contextvars.ContextVar("yawt_active_tile_caches", default=())
)


def active_tile_cache() -> _ColumnTileCache | None:
    """The innermost ambient tile cache of the current context (see
    :func:`measurement_tile_cache`), or None."""
    stack = _ACTIVE_CACHES.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def measurement_tile_cache(
    tile_cache_bytes: int = 16 << 30,
    resident_tile_bytes: int | None = None,
):
    """A tile cache scoped to one or more measurements.

    Passed as ``cache=`` to several :func:`count_pairs_blocked` calls, the
    count types of one measurement share their packed (and, within the
    resident budget, device-uploaded) patch blocks: DD and RD of a
    cross-correlation both stream the unknown catalog as their column
    side, DD and DR both stream the reference as rows — each catalog then
    crosses the host-device link once per measurement instead of once per
    count. Keys include the catalog identity, binning, counting mode and
    tile layout, so only genuinely identical tile sets are ever shared;
    both budget knobs behave exactly as on :func:`count_pairs_blocked`.

    While the context is open it is also the AMBIENT cache: blocked
    measurements started inside it (``max_resident_patches`` set, no
    explicit ``cache=``) reuse it instead of creating their own. Holding
    one context around several measurements therefore shares packed and
    device-resident blocks between them — the production pattern where
    the same reference catalog appears in every tomographic bin's
    cross-correlation then streams that catalog through the host-device
    link once per SESSION instead of once per measurement::

        with measurement_tile_cache():
            w_ss = autocorrelate(config, reference, ref_rand,
                                 max_resident_patches=24)
            for unknown in tomographic_bins:
                crosscorrelate(config, reference, unknown,
                               ref_rand=ref_rand,
                               max_resident_patches=24)

    The memory bounds are unchanged (the budgets cap the resident and
    spilled bytes for the whole session). Catalogs are keyed weakly:
    the cache never extends their lifetime, and entries of freed
    catalogs are reclaimed under budget pressure.
    """
    resident_tile_bytes = _resolve_resident_bytes(resident_tile_bytes)
    with contextlib.ExitStack() as stack:
        cache = _make_tile_cache(
            stack, tile_cache_bytes, resident_tile_bytes, store_rows=True
        )
        stack_token = _ACTIVE_CACHES.set(_ACTIVE_CACHES.get() + (cache,))
        try:
            yield cache
        finally:
            _ACTIVE_CACHES.reset(stack_token)
        logger.debug(
            "measurement tile cache: %d hits, %d rebuilds",
            cache.hits, cache.misses,
        )


def count_pairs_blocked(
    edges: AngularEdges,
    linkage: Linkage,
    catalog1: Catalog,
    catalog2: Catalog,
    binning: Binning,
    *,
    auto: bool,
    binned2: bool,
    mode: str = "nn",
    max_resident_patches: int = 16,
    tile_size: int | None = None,
    backend: str = "auto",
    mesh=None,
    data_sharding: str = "replicated",
    progress: bool = False,
    tile_cache_bytes: int = 16 << 30,
    resident_tile_bytes: int | None = None,
    cache: _ColumnTileCache | None = None,
    audit: bool = False,
) -> np.ndarray:
    """Count pairs block by block; returns per-scale counts with shape
    ``(num_scales, num_bins, num_patches, num_patches)`` (same contract as
    the in-memory engine path after scatter).

    With ``mesh`` each resident block pair is evaluated sharded over the
    device mesh (see
    :func:`yet_another_wizz_tpu.parallel.count_pairs_sharded`) — the
    combination of host-side patch-block streaming with device-sharded
    execution is the out-of-core layout for pod-scale runs where not even
    a patch block fits a single chip.

    Column-block tile sets are cached per call at two levels (see
    :class:`_ColumnTileCache`): up to ``resident_tile_bytes`` of packed
    blocks stay resident in device memory (env ``YAWT_RESIDENT_TILE_BYTES``
    overrides; default 4 GiB; 0 disables), so revisits skip the
    host-device upload entirely; blocks beyond that spill to a disk cache
    (capped at ``tile_cache_bytes``; 0 disables) and are re-uploaded per
    row sweep. The device working set is therefore bounded by
    ``resident_tile_bytes`` plus the in-flight block pairs
    (:data:`PIPELINE_DEPTH`); the host additionally holds up to
    ``YAWT_PREFETCH_BLOCKS`` (default 1) PREFETCHED blocks per side —
    upcoming row and column blocks are packed on worker threads while
    the current block pair queues device work. Deeper prefetch is an
    experiment knob: on a link-bound device the pack waits are upload
    staging, which deeper lookahead only reshuffles. In autocorrelation-shaped counts (same
    catalog, binning and layout on both sides) the row blocks reuse the
    same cache, skipping the per-sweep row packing as well.

    With ``cache=`` an externally created cache (see
    :func:`measurement_tile_cache`) is used as-is — shared across the
    calls of one measurement, with the budgets fixed at its creation
    (``tile_cache_bytes``/``resident_tile_bytes`` are then ignored).

    ``audit=True`` runs the exact-boundary float64 repair per block pair
    (see :func:`yet_another_wizz_tpu.ops.paircount.audit_boundary_counts`);
    each block pair's count is then evaluated synchronously (no deferred
    pipeline) and separation-weighted configs use the cumulative
    union-edge formulation — certification costs throughput."""
    from yet_another_wizz_tpu.ops.tiles import DEFAULT_TILE_SIZE

    tile_size = tile_size or DEFAULT_TILE_SIZE
    num_patches = catalog1.num_patches
    if catalog2.num_patches != num_patches:
        # blocks and the result shape derive from catalog1: a mismatched
        # catalog2 would silently drop its extra patches from the counts
        # (the measurement layer checks centers too; this is the guard
        # for direct engine calls)
        raise ValueError(
            "catalogs have different patch counts: "
            f"{num_patches} != {catalog2.num_patches}"
        )
    num_bins = len(binning)
    block = max(1, int(max_resident_patches) // 2)  # two resident sides
    starts = list(range(0, num_patches, block))

    # mirror the in-memory engine's tile-layout policy
    # (ops.tiles.preferred_tile_layout): without it the bin_max_angles
    # pruning below is ineffective — spatial tiles span every redshift
    # bin, so the per-tile cutoff collapses to the global maximum and the
    # disjoint-bin drop never fires
    from yet_another_wizz_tpu.ops.tiles import preferred_tile_layout

    layout1 = preferred_tile_layout(
        catalog1, num_bins, float(edges.max_angle),
        equal_bin_counting=binned2, tile_size=tile_size,
    )
    layout2 = (
        preferred_tile_layout(
            catalog2, num_bins, float(edges.max_angle),
            equal_bin_counting=True, tile_size=tile_size,
        )
        if binned2
        else "spatial"
    )

    indicator = None
    if progress:
        from yet_another_wizz_tpu.utils.logging import Indicator

        indicator = iter(Indicator(range(len(starts) ** 2), len(starts) ** 2))

    result = np.zeros(
        (edges.num_scales, num_bins, num_patches, num_patches)
    )

    resident_tile_bytes = _resolve_resident_bytes(resident_tile_bytes)

    with contextlib.ExitStack() as stack:
        if cache is None:
            # the ambient measurement_tile_cache() applies to DIRECT
            # engine calls too, not only measurements started through
            # the correlation functions (which resolve it one level up)
            cache = active_tile_cache()
        own_cache = cache is None
        if (
            own_cache
            and (tile_cache_bytes > 0 or resident_tile_bytes > 0)
            and len(starts) > 1
        ):
            cache = _make_tile_cache(
                stack, tile_cache_bytes, resident_tile_bytes
            )
        result = _blocked_loop(
            edges, linkage, catalog1, catalog2, binning, starts, block,
            auto=auto, binned2=binned2, mode=mode, tile_size=tile_size,
            backend=backend, mesh=mesh, data_sharding=data_sharding,
            layout1=layout1, layout2=layout2, indicator=indicator,
            num_patches=num_patches, result=result, cache=cache,
            audit=audit,
        )
        if own_cache and cache is not None:
            logger.debug(
                "column tile cache: %d hits, %d rebuilds",
                cache.hits, cache.misses,
            )
    return result


_scatter_scales_jit = None


def _scatter_block_scales(counts, scale_map, idx, accum):
    """On-device per-scale reduction + scatter of one block pair.

    ``counts``: the engine's BUCKETED ``(K, B, E)`` float32 cumulative
    output (``padded_slots=True``); ``scale_map``: the mapper's
    ``(B, E-1, S)`` interval-to-scale table; ``idx``: a host-built
    ``(3, K)`` int32 stack of global patch indices ``(g1, g2)`` plus a
    validity/halving code (0 = padding or dump row, 1 = auto same-patch
    half weight, 2 = full weight); ``accum``: the running
    ``(S, B, P+1, P+1)`` float32 result (row/column ``P`` is the dump
    target of padded entries, sliced off at fetch time).

    The padding rows of ``counts`` hold the dump slot's counts of padding
    pairs, so invalid rows are removed with a ``jnp.where`` selection,
    which unlike a multiplicative mask cannot propagate a non-finite
    value. Everything runs in float32: the interval
    differences are exactly-rounded subtractions of the float32
    cumulatives (no cancellation amplification — the error is relative to
    the interval value) and the scale reduction sums a handful of
    non-negative terms per scale, bounded well inside the engine's 1e-6
    oracle-parity budget. Each global patch pair lives in exactly ONE
    block pair, so the scatter adds every slot once — there is no
    round-off accumulation across block pairs.
    """
    import jax
    import jax.numpy as jnp

    global _scatter_scales_jit
    if _scatter_scales_jit is None:

        def _impl(counts, scale_map, idx, accum):
            intervals = jnp.diff(counts, axis=-1)  # (K, B, E-1)
            per_scale = jnp.einsum(
                "kbe,bes->sbk", intervals, scale_map,
                precision=jax.lax.Precision.HIGHEST,
            )
            factor = idx[2].astype(jnp.float32) * 0.5
            contrib = jnp.where(factor > 0.0, per_scale * factor, 0.0)
            return accum.at[:, :, idx[0], idx[1]].add(contrib)

        # no buffer donation: the accumulator is ~O(P^2) small, and CPU
        # (the test platform) logs a warning for every donated call
        _scatter_scales_jit = jax.jit(_impl)
    return _scatter_scales_jit(counts, scale_map, idx, accum)


PIPELINE_DEPTH = 8
"""Deferred block pairs kept in flight: the device computes (and the
result transfers) block pairs while the host packs/loads the tiles of
later ones, and finished results are fetched in BATCHES of half the
depth through one jax.device_get call each, so the fixed cost of a
host-device transfer is paid once per batch instead of once per block
pair. Live device inputs are bounded at
``PIPELINE_DEPTH`` block pairs; the working-set guarantee of the
blocked path scales accordingly (a block pair is ~2 x block x
patch-size x 32 B, far below HBM for any practical block size)."""


def _blocked_loop(
    edges, linkage, catalog1, catalog2, binning, starts, block,
    *, auto, binned2, mode, tile_size, backend, mesh, data_sharding,
    layout1, layout2, indicator, num_patches, result, cache,
    audit=False,
):
    import time

    from yet_another_wizz_tpu.utils.devicemem import track_if_device

    t_entry = time.perf_counter()
    phases = {"rows": 0.0, "cols": 0.0, "pairs": 0.0, "queue": 0.0,
              "drain": 0.0, "drain_wait": 0.0, "drain_fetch": 0.0,
              "drain_scatter": 0.0, "preamble": 0.0, "teardown": 0.0}

    def timed(key, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phases[key] += time.perf_counter() - t0
        return out

    pending: list = []

    def drain(keep: int) -> None:
        """Fetch and scatter finished block pairs beyond ``keep``.

        All drained results come down in ONE ``jax.device_get`` call:
        batching the transfers amortises the fixed cost of each
        host-device transfer.

        In the on-device accumulation mode (see below) the pending
        entries hold only the raw count tensors — draining then just
        WAITS on the older ones to bound the in-flight device inputs;
        nothing crosses the link until the single accumulator fetch at
        the end of the sweep."""
        import jax
        import time

        t0 = time.perf_counter()
        if len(pending) > keep:
            take = pending[: len(pending) - keep]
            del pending[: len(pending) - keep]
            # wait / fetch split: block_until_ready isolates waiting out
            # the device queue from the actual result transfer, so the
            # debug phase log attributes transfer time correctly
            outs = [item[0] for item in take]
            jax.block_until_ready(outs)
            t1 = time.perf_counter()
            phases["drain_wait"] += t1 - t0
            if len(take[0]) == 1:  # accumulate mode: no per-pair fetch
                phases["drain"] += time.perf_counter() - t0
                return
            fetched = jax.device_get(outs)
            t2 = time.perf_counter()
            phases["drain_fetch"] += t2 - t1
            for (_, mapper, pairs, lo1, lo2), values in zip(take, fetched):
                cumulative = np.asarray(values, dtype=np.float64)
                per_scale = mapper.counts_to_scales(cumulative)
                global1 = pairs.slot_patches[:, 0] + lo1
                global2 = pairs.slot_patches[:, 1] + lo2
                if auto:
                    same = global1 == global2
                    per_scale[:, same, :] *= 0.5
                result[:, :, global1, global2] += np.moveaxis(
                    per_scale, 1, -1
                )
            phases["drain_scatter"] += time.perf_counter() - t2
        phases["drain"] += time.perf_counter() - t0

    # cache keys carry everything that shapes a block's tile set, so a
    # measurement-scoped cache shares only genuinely identical blocks
    # between count types. Catalog identity is keyed through weakrefs —
    # freed-id reuse cannot collide and lifetimes are not extended.
    # Row blocks are admitted when the cache is measurement-scoped
    # (store_rows) or when both sides are identical
    # (autocorrelation-shaped counts, where the row key coincides with
    # the column key).
    cache_rows = False
    row_base = col_base = None
    gen_token = None
    if cache is not None:
        # binning is keyed by VALUE so measurements built from equal but
        # distinct Configuration objects still share blocks; catalogs are
        # keyed by WEAK identity (their data has no cheap content
        # fingerprint): while a catalog lives, its tokens are equal; once
        # freed, its entries can never match again and are purged under
        # budget pressure — id reuse cannot collide and the cache never
        # extends catalog lifetimes (a pipeline-long ambient cache must
        # not accumulate every task's in-memory catalogs)
        binning_key = (binning.edges.tobytes(), str(binning.closed))
        row_base = (
            _WeakId(catalog1), binning_key, mode[0], layout1, block,
            tile_size,
        )
        col_base = (
            _WeakId(catalog2), binning_key if binned2 else None,
            mode[1], layout2, block, tile_size,
        )
        cache_rows = cache.store_rows or row_base == col_base
        # new generation: every RUNNING count's entries are protected
        # from eviction; entries last used before the oldest running
        # count began become evictable under budget pressure, and
        # entries of freed catalogs are reclaimed
        gen_token = cache.begin_count()

    # resolve the engine's effective placement ONCE, with the same rules
    # count_pairs_tiles applies per call (auto_mesh is deterministic
    # within a process): upload warming must track where lanes actually
    # go — warming on the raw `mesh is None` would pre-upload full
    # blocks to device 0 on auto-meshed multi-chip hosts (never read:
    # the sharded path places lanes per call) and skip the single-device
    # pin mesh="single"
    if backend == "oracle":
        single_device = False  # host path: no device arrays at all
    elif mesh == "single":
        single_device = True
    elif mesh is None:
        from yet_another_wizz_tpu.parallel import auto_mesh

        single_device = auto_mesh() is None
    else:
        single_device = False

    # On-device result accumulation (single-device engines, no audit —
    # audit returns repaired HOST counts): blocks partition patches, so
    # each global patch pair is computed by exactly one block pair and
    # the per-scale reduction + scatter can run on the device into one
    # small (S, B, P+1, P+1) float32 accumulator. One ~O(P^2) fetch per
    # count then replaces the per-block-pair (slots, B, E) transfers —
    # at survey scale this removes ~100 MB of result traffic per count
    # from a link whose bandwidth is the measured bottleneck.
    # YAWT_DEVICE_ACCUMULATE=0 restores the per-block-pair host fetch
    # (the same escape-hatch convention as YAWT_LANE_ENCODING=float).
    import os

    device_accumulate = (
        single_device
        and not audit
        and os.environ.get("YAWT_DEVICE_ACCUMULATE", "1").strip() != "0"
    )
    accum_state = {"accum": None, "scale_map": None}

    def queue_scatter(cumulative, mapper, pairs, lo1, lo2):
        """Queue the on-device reduction of one block pair's counts."""
        import jax.numpy as jnp

        from yet_another_wizz_tpu.ops.paircount import _device_table
        from yet_another_wizz_tpu.utils.devicemem import track

        if accum_state["accum"] is None:
            accum_state["accum"] = track(
                jnp.zeros(
                    (
                        result.shape[0],
                        result.shape[1],
                        num_patches + 1,
                        num_patches + 1,
                    ),
                    dtype=jnp.float32,
                ),
                "blocked_accumulator",
            )
        if accum_state["scale_map"] is None:
            accum_state["scale_map"] = track(
                _device_table(mapper.scale_maps), "edge_tables"
            )
        # one stacked int32 upload per block pair (every host-to-device
        # transfer pays a full link round trip): global patch indices
        # plus the validity/halving code consumed by the jitted scatter
        k = cumulative.shape[0]
        idx = np.zeros((3, k), dtype=np.int32)
        idx[0] = num_patches  # padding/dump rows scatter to the dump row
        idx[1] = num_patches
        n = len(pairs.slot_patches)
        global1 = pairs.slot_patches[:, 0] + lo1
        global2 = pairs.slot_patches[:, 1] + lo2
        idx[0, :n] = global1
        idx[1, :n] = global2
        if auto:
            idx[2, :n] = np.where(global1 == global2, 1, 2)
        else:
            idx[2, :n] = 2
        # each functional update is a fresh device buffer; tracking it
        # (and letting the superseded one credit back on GC) keeps the
        # accumulator honestly charged — the brief old+new overlap is
        # real HBM double-residency
        accum_state["accum"] = track(
            _scatter_block_scales(
                cumulative, accum_state["scale_map"], jnp.asarray(idx),
                accum_state["accum"],
            ),
            "blocked_accumulator",
        )

    def warm_upload(tiles):
        """Start the async host-to-device transfer of a block's lanes
        from the prefetch worker (single-device engines only: under a
        mesh the engine places lanes per call with its own shardings).
        jax transfers are thread-safe and asynchronous, so the upload
        overlaps the CURRENT block pair's queued compute — on a
        link-bound device the uncached path then runs at the transfer
        rate instead of serialising pack -> upload -> compute."""
        if single_device:
            tiles.device_data()
        return tiles

    # persistent packed-tile stores (catalog/tilestore.py): packed
    # blocks are a pure function of (catalog, binning, mode, layout,
    # block size, tile size), so for disk-cached catalogs they live
    # next to the patch cache and survive across measurements AND
    # processes — a warm-cache measurement then streams disk -> device
    # instead of re-paying the O(N) Morton sort + native pack per run
    # (at 100M rows: ~42 s of a 79 s warm wall before round 5)
    from yet_another_wizz_tpu.catalog.tilestore import PackedTileStore

    row_store = PackedTileStore.open(
        catalog1, binning, mode[0], layout1, block, tile_size
    )
    col_store = PackedTileStore.open(
        catalog2, binning if binned2 else None, mode[1], layout2, block,
        tile_size,
    )

    def acquire_rows(lo1):
        """Load-or-build the row tile set for one block (thread-safe:
        cache loads are read-only, ``load_block`` is a stateless read,
        and the session-cache store happens in the main thread
        afterwards; persistent-store saves are independent atomic
        files)."""
        hi1 = min(lo1 + block, num_patches)
        if cache_rows:
            tiles = cache.load(row_base + (lo1,))
            if tiles is not None:
                return warm_upload(tiles), False
        if row_store is not None:
            tiles = row_store.load(lo1)
            if tiles is not None:
                # built=True: a persistent hit still enters the session
                # cache so later sweeps skip the disk read AND reuse the
                # uploaded device arrays
                return warm_upload(tiles), True
        tiles = _build_block_tiles(
            catalog1, binning, mode[0], lo1, hi1, tile_size, layout=layout1
        )
        if row_store is not None:
            row_store.save(lo1, tiles)
        return warm_upload(tiles), True

    def acquire_cols(lo2):
        """Column-side counterpart of :func:`acquire_rows`."""
        hi2 = min(lo2 + block, num_patches)
        if cache is not None:
            tiles = cache.load(col_base + (lo2,))
            if tiles is not None:
                return warm_upload(tiles), False
        if col_store is not None:
            tiles = col_store.load(lo2)
            if tiles is not None:
                return warm_upload(tiles), True
        tiles = _build_block_tiles(
            catalog2, binning if binned2 else None, mode[1],
            lo2, hi2, tile_size, layout=layout2,
        )
        if col_store is not None:
            col_store.save(lo2, tiles)
        return warm_upload(tiles), True

    def qualifying_linkage(lo1, lo2):
        """The masked linked matrix of a block pair, or None when the
        pair contributes nothing. The single source of truth for which
        block pairs run — the prefetch schedules (``pair_seq``) and the
        main loop both consume it, so they cannot drift apart."""
        hi1 = min(lo1 + block, num_patches)
        hi2 = min(lo2 + block, num_patches)
        if auto and hi2 <= lo1:
            return None  # only patch pairs with id2 >= id1 contribute
        linked = linkage.linked[lo1:hi1, lo2:hi2]
        if auto:
            # mask patch pairs below the diagonal
            ids1 = np.arange(lo1, hi1)[:, None]
            ids2 = np.arange(lo2, hi2)[None, :]
            linked = linked & (ids2 >= ids1)
        return linked if linked.any() else None

    # prefetch per side: packing upcoming row/column blocks (Morton sort
    # + native scatter, seconds at survey scale) overlaps the current
    # block pair's pair-list build and queued device work. numpy sorting
    # and the native packer release the GIL, so up to two workers per
    # side give real parallelism. The column prefetch matters on the
    # FIRST row sweep (and whenever the cache is disabled); afterwards
    # column loads hit the resident cache. Host working set grows by up
    # to ``YAWT_PREFETCH_BLOCKS`` in-flight blocks per side (default 1:
    # deeper prefetch has not been measured on the GPU).
    from concurrent.futures import ThreadPoolExecutor

    # evaluated once per (lo1, lo2); the main loop reuses the slices
    # (at survey scale the full grid is large and each entry allocates)
    linked_by_pair = {
        (lo1, lo2): linked
        for lo1 in starts
        for lo2 in starts
        if (linked := qualifying_linkage(lo1, lo2)) is not None
    }
    pair_seq = list(linked_by_pair)
    row_needed = list(dict.fromkeys(lo1 for lo1, _ in pair_seq))
    prefetch_depth = max(
        1, int(os.environ.get("YAWT_PREFETCH_BLOCKS", "1") or 1)
    )
    executor = (
        ThreadPoolExecutor(
            max_workers=min(2, prefetch_depth),
            thread_name_prefix="yawt-rowpack",
        )
        if len(row_needed) > 1 else None
    )
    col_executor = (
        ThreadPoolExecutor(
            max_workers=min(2, prefetch_depth),
            thread_name_prefix="yawt-colpack",
        )
        if len(pair_seq) > 1 else None
    )
    futures: dict = {}
    col_futures: dict = {}
    # cursors walk the consumption sequences; top-up keeps up to
    # ``prefetch_depth`` futures outstanding per side. Both dicts are
    # touched from the main thread only (submit + pop) — the workers
    # never see them. A cursor may skip a block whose future is consumed
    # before its later duplicate position comes up; the fallback direct
    # acquire then hits the resident cache, which is what the duplicate
    # would have loaded anyway.
    row_cursor = [0]
    col_cursor = [0]

    def top_up_rows() -> None:
        if executor is None:
            return
        while (
            len(futures) < prefetch_depth
            and row_cursor[0] < len(row_needed)
        ):
            lo1 = row_needed[row_cursor[0]]
            row_cursor[0] += 1
            if lo1 not in futures:
                futures[lo1] = executor.submit(acquire_rows, lo1)

    def top_up_cols() -> None:
        if col_executor is None:
            return
        while (
            len(col_futures) < prefetch_depth
            and col_cursor[0] < len(pair_seq)
        ):
            lo2 = pair_seq[col_cursor[0]][1]
            col_cursor[0] += 1
            if lo2 not in col_futures:
                col_futures[lo2] = col_executor.submit(acquire_cols, lo2)

    top_up_rows()
    top_up_cols()

    # on built=True both getters re-check the RESIDENT cache layer before
    # storing: in autocorrelation-shaped counts row and column keys
    # coincide, so a prefetch worker can build a block whose twin landed
    # in the cache (with device arrays already uploaded) while it was
    # packing. Preferring the resident twin turns the waste from "packed
    # twice, uploaded twice, 2x HBM for a sweep" into "packed twice in a
    # worker whose time was hidden anyway". A DISK-spilled twin is never
    # preferred — deserializing and re-uploading it loses to the
    # just-built tiles the getter already holds.
    def get_row_tiles(lo1):
        fut = futures.pop(lo1, None)
        if fut is not None:
            tiles, built = timed("rows", fut.result)
        else:
            tiles, built = timed("rows", acquire_rows, lo1)
        if built and cache_rows:
            cached = (
                cache.load(row_base + (lo1,), count=False, resident_only=True)
                if row_base == col_base else None
            )
            if cached is not None:
                tiles = cached  # twin stored by the column path meanwhile
            else:
                timed("rows", cache.store, row_base + (lo1,), tiles)
        top_up_rows()
        return tiles

    def get_col_tiles(lo2):
        fut = col_futures.pop(lo2, None)
        if fut is not None:
            tiles, built = timed("cols", fut.result)
        else:
            tiles, built = timed("cols", acquire_cols, lo2)
        if built and cache is not None:
            cached = (
                cache.load(col_base + (lo2,), count=False, resident_only=True)
                if cache_rows and row_base == col_base else None
            )
            if cached is not None:
                tiles = cached  # twin stored by the row path meanwhile
            else:
                timed("cols", cache.store, col_base + (lo2,), tiles)
        top_up_cols()
        return tiles

    num_block_pairs = 0
    num_candidate_pairs = 0
    # direct separation-weighted counting when available (audit and the
    # oracle backend require the union representation, see
    # measurements._run_engine); the combined device table is built
    # once — not per block pair on the queueing hot path
    direct = edges.direct if backend != "oracle" and not audit else None
    direct_table = direct.combined_table() if direct is not None else None
    # preamble: everything between entry and the first block pair —
    # layout choice, the linked-pair grid, store fingerprints, executor
    # setup (the sweep's own clock starts at the loop)
    phases["preamble"] = time.perf_counter() - t_entry

    try:
        for lo1 in starts:
            tiles1 = None  # built lazily: the block pair may be pruned
            for lo2 in starts:
                if indicator is not None:
                    next(indicator, None)
                linked = linked_by_pair.get((lo1, lo2))
                if linked is None:
                    continue

                if tiles1 is None:
                    tiles1 = get_row_tiles(lo1)
                tiles2 = get_col_tiles(lo2)

                local_linkage = type(linkage)(
                    max_angle=linkage.max_angle, linked=linked
                )
                # enumerate tile pairs with LOCAL patch ids; the
                # auto-diagonal handling is already applied to the
                # linked matrix by qualifying_linkage
                pairs = timed(
                    "pairs", build_tile_pairs,
                    tiles1, tiles2, local_linkage, auto=False,
                    bin_max_angles=edges.edges.max(axis=1),
                )
                if pairs.num_pairs == 0:
                    continue
                num_block_pairs += 1
                num_candidate_pairs += (
                    int(pairs.num_pairs)
                    * tiles1.tile_size * tiles2.tile_size
                )

                # defer=True queues the device work; the fetch + scatter
                # happen in drain() while later block pairs pack and
                # upload
                if direct is not None:
                    cumulative = timed(
                        "queue", count_pairs_tiles,
                        tiles1, tiles2, pairs, direct_table,
                        backend=backend, edges_radian=direct.edges,
                        mesh=mesh, data_sharding=data_sharding,
                        direct=direct.spec, defer=True,
                        padded_slots=device_accumulate,
                    )
                    mapper = direct
                else:
                    # audit=True runs the boundary-flag pass and float64
                    # repair per block pair and returns HOST counts
                    # (count_pairs_tiles forces sync when auditing; the
                    # drain machinery passes host arrays through)
                    cumulative = timed(
                        "queue", count_pairs_tiles,
                        tiles1, tiles2, pairs, edges.chord2_table,
                        backend=backend, edges_radian=edges.edges,
                        mesh=mesh, data_sharding=data_sharding,
                        audit=audit, defer=True,
                        padded_slots=device_accumulate,
                    )
                    mapper = edges
                track_if_device(cumulative, "inflight_counts")
                if device_accumulate:
                    timed(
                        "queue", queue_scatter,
                        cumulative, mapper, pairs, lo1, lo2,
                    )
                    pending.append((cumulative,))
                else:
                    pending.append((cumulative, mapper, pairs, lo1, lo2))
                if len(pending) >= PIPELINE_DEPTH:
                    drain(PIPELINE_DEPTH // 2)

        drain(0)
        if accum_state["accum"] is not None:
            # the single result fetch of the accumulation mode
            import time as _time

            import jax

            t0 = _time.perf_counter()
            jax.block_until_ready(accum_state["accum"])
            t1 = _time.perf_counter()
            phases["drain_wait"] += t1 - t0
            fetched = jax.device_get(accum_state["accum"])
            t2 = _time.perf_counter()
            phases["drain_fetch"] += t2 - t1
            result += np.asarray(fetched, dtype=np.float64)[
                :, :, :num_patches, :num_patches
            ]
            phases["drain_scatter"] += _time.perf_counter() - t2
            phases["drain"] += _time.perf_counter() - t0
    finally:
        # shut the prefetch workers down on EVERY path: an exception
        # mid-sweep must not leak two live executors whose pending
        # futures pin packed blocks (GBs of host memory at survey scale)
        t_teardown = time.perf_counter()
        for pool in (executor, col_executor):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        if gen_token is not None:
            cache.end_count(gen_token)
        phases["teardown"] = time.perf_counter() - t_teardown
    if indicator is not None:
        next(indicator, None)  # drain: prints the 100% line + newline

    logger.debug(
        "processed %d resident block pairs of <=%d patches "
        "(rows %.2fs, cols %.2fs, pair lists %.2fs, queue %.2fs, "
        "drain %.2fs = wait %.2fs + fetch %.2fs + scatter %.2fs)",
        num_block_pairs,
        block,
        phases["rows"], phases["cols"], phases["pairs"],
        phases["queue"], phases["drain"], phases["drain_wait"],
        phases["drain_fetch"], phases["drain_scatter"],
    )
    for key, value in phases.items():
        PHASE_TOTALS[key] = PHASE_TOTALS.get(key, 0.0) + value
    PHASE_TOTALS["num_block_pairs"] = (
        PHASE_TOTALS.get("num_block_pairs", 0) + num_block_pairs
    )
    # the engine's work statistic (num_tile_pairs x tile_size^2), summed
    # over blocks — the only place it is knowable for LazyCatalogs, whose
    # full-catalog tile sets never exist (read by scripts/survey_proof.py)
    PHASE_TOTALS["candidate_pairs"] = (
        PHASE_TOTALS.get("candidate_pairs", 0) + num_candidate_pairs
    )
    return result


PHASE_TOTALS: dict = {}
"""Accumulated wall-clock phase breakdown of the blocked counts run on
this process (diagnostic, read by bench.py; reset with
:func:`reset_phase_totals`): host tile packing (``rows``, ``cols``),
pair-list builds (``pairs``), device dispatch (``queue``) and result
drains split into device-queue ``drain_wait``, host-device link
``drain_fetch`` and host ``drain_scatter``, plus the work counters
``num_block_pairs`` and ``candidate_pairs``. Attributes where a blocked
run's wall time goes."""


def reset_phase_totals() -> None:
    """Clear :data:`PHASE_TOTALS` (start of a timed window)."""
    PHASE_TOTALS.clear()
