"""Persistent packed-tile cache attached to a catalog's cache directory.

The packed tile sets the blocked engine streams to the device are a pure
function of (catalog data, binning, counting mode, tile layout, block
decomposition) — yet they were rebuilt from the raw cached rows on every
measurement: Morton sort, native scatter and fixed-point staging cost
~48 s of a 79 s warm wall at 100M rows (round-4 survey proof), all of it
recomputing bytes that a previous run already produced. This module
persists the packed blocks next to the patch cache, keyed by a
fingerprint of everything that shapes them, so a measurement over a
cached catalog streams disk -> device with near-zero host repacking.

This mirrors the reference's binning-fingerprinted tree cache
(/root/reference/src/yaw/catalog/trees.py:442-447,519-524 — trees are
cached per patch and invalidated when the binning fingerprint changes),
generalised to the device engine's block tile sets and with multiple
fingerprints retained (a pipeline interleaving two binnings must not
thrash).

Layout on disk::

    <cache_directory>/tiles/<fingerprint>/block_<patch_lo>.npz

Each ``.npz`` holds the full :class:`~yet_another_wizz_tpu.ops.tiles.
TileSet` field set (the same serialisation the blocked path's
session-scoped spill cache uses). Writes go through a temp file + atomic
rename, so concurrent measurements (threads or processes) can share a
store without locking; a torn write can never be observed. Stale
fingerprint directories are pruned oldest-first beyond
:data:`MAX_FINGERPRINTS`.

``YAWT_TILE_STORE=0`` disables the store entirely (measurements then
always repack, the pre-round-5 behaviour).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from yet_another_wizz_tpu.binning import Binning
    from yet_another_wizz_tpu.ops.tiles import TileSet

__all__ = [
    "PackedTileStore",
    "TILE_SET_ARRAYS",
    "TILE_SET_SCALARS",
    "tileset_payload",
    "tileset_from_payload",
]

logger = logging.getLogger(__name__)

TILE_STORE_FORMAT = 1
"""Bumped whenever the TileSet field set or packing semantics change:
the fingerprint embeds it, so stale stores are invalidated, not
misread."""

MAX_FINGERPRINTS = 4
"""Fingerprint directories retained per store. A pipeline alternating a
few binnings/layouts keeps all of them warm; an unbounded store would
grow by ~the catalog's packed size for every configuration ever used."""

TILE_SET_SCALARS = (
    "num_bins", "num_points", "tile_size", "device_pad_base",
)
TILE_SET_ARRAYS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax",
)


def tileset_payload(tiles: TileSet) -> dict:
    """The npz payload serialising one tile set (shared by the
    persistent store and the session spill cache)."""
    payload = {name: getattr(tiles, name) for name in TILE_SET_ARRAYS}
    payload.update(
        {name: np.asarray(getattr(tiles, name)) for name in TILE_SET_SCALARS}
    )
    if tiles.sum_kappa is not None:
        payload["sum_kappa"] = tiles.sum_kappa
    return payload


def tileset_from_payload(payload) -> TileSet:
    """Rebuild a :class:`TileSet` from a (possibly lazily mapped) npz
    payload."""
    from yet_another_wizz_tpu.ops.tiles import TileSet

    fields = {name: payload[name] for name in TILE_SET_ARRAYS}
    fields.update(
        {name: payload[name].item() for name in TILE_SET_SCALARS}
    )
    fields["sum_kappa"] = (
        payload["sum_kappa"] if "sum_kappa" in payload else None
    )
    return TileSet(**fields)


def _store_enabled() -> bool:
    return os.environ.get("YAWT_TILE_STORE", "1").strip() != "0"


class PackedTileStore:
    """One catalog-side store for one block-tiling configuration.

    Opened per blocked count via :meth:`open`; ``None`` when the catalog
    has no cache directory (in-memory data has no durable home and the
    session caches already cover repeated measurements) or the store is
    disabled. ``load``/``save`` are thread-safe through filesystem
    atomicity — save never overwrites and load treats any unreadable
    file as a miss.
    """

    def __init__(self, directory: Path, fingerprint: str) -> None:
        self._root = Path(directory)
        self._dir = self._root / fingerprint
        self._fingerprint = fingerprint
        self._disabled = False
        self.hits = 0
        self.misses = 0

    @classmethod
    def open(
        cls,
        catalog,
        binning: Binning | None,
        mode: str,
        layout: str,
        block: int,
        tile_size: int,
        device_pad_base: int = 64,
    ) -> PackedTileStore | None:
        """A store for ``catalog`` under the given tiling configuration,
        or None when the catalog is not disk-cached / the store is off.

        The fingerprint covers the store format version, every parameter
        that shapes the packed blocks, and a cheap data fingerprint (per
        -patch record counts + weight sums + the column layout): a
        re-ingested cache with different rows, a changed binning, or a
        changed tile layout each hash to a fresh directory, so stale
        blocks can never be served (invalidation-by-key, like the
        reference's tree cache).
        """
        cache_dir = getattr(catalog, "cache_directory", None)
        if cache_dir is None or not _store_enabled():
            return None
        try:
            num_records = tuple(catalog.get_num_records())
            sum_weights = tuple(catalog.get_sum_weights())
        except Exception:  # no metadata -> no safe invalidation key
            return None
        hasher = hashlib.sha256()

        def feed(part) -> None:
            data = part if isinstance(part, bytes) else str(part).encode()
            hasher.update(data)
            hasher.update(b"\x00")

        feed(TILE_STORE_FORMAT)
        if binning is None:
            feed("unbinned")
        else:
            feed(binning.edges.tobytes())
            feed(binning.closed)
        feed(mode)
        feed(layout)
        feed(block)
        feed(tile_size)
        feed(device_pad_base)
        feed(catalog.num_patches)
        feed(np.asarray(num_records, dtype=np.int64).tobytes())
        feed(np.asarray(sum_weights, dtype=np.float64).tobytes())
        chunk_info = getattr(catalog, "attrs", None)
        if chunk_info is not None:
            feed(chunk_info.get_list())
        return cls(Path(cache_dir) / "tiles", hasher.hexdigest()[:20])

    def _path(self, patch_lo: int) -> Path:
        return self._dir / f"block_{patch_lo}.npz"

    def load(self, patch_lo: int) -> TileSet | None:
        """The stored tile set for the block starting at ``patch_lo``,
        or None. Any read failure (torn file from a crashed writer,
        version skew inside one fingerprint — impossible by key, but
        cheap to guard) degrades to a miss and removes the bad file."""
        path = self._path(patch_lo)
        try:
            with np.load(path) as payload:
                tiles = tileset_from_payload(payload)
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception as err:
            logger.warning(
                "dropping unreadable packed-tile block %s (%s)", path, err
            )
            try:
                path.unlink()
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        return tiles

    def save(self, patch_lo: int, tiles: TileSet) -> None:
        """Persist one packed block (atomic; never overwrites a block a
        concurrent writer landed first). A failed write — e.g. a full
        disk — disables this store instance rather than failing the
        measurement or retrying on every block."""
        if self._disabled:
            return
        path = self._path(patch_lo)
        if path.exists():
            return
        try:
            self._dir.mkdir(parents=True, exist_ok=True)
            self._prune_stale()
            fd, tmp = tempfile.mkstemp(
                dir=self._dir, prefix=path.stem, suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **tileset_payload(tiles))
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError as err:
            logger.warning(
                "disabling packed-tile store %s: write failed (%s)",
                self._dir, err,
            )
            self._disabled = True

    def _prune_stale(self) -> None:
        """Drop the oldest fingerprint directories beyond
        :data:`MAX_FINGERPRINTS` (the active fingerprint is always
        kept). mtime of the directory tracks its last save; load hits
        do not refresh it — a long-lived read-mostly fingerprint is
        still protected by being within the retention count."""
        try:
            others = [
                entry
                for entry in self._root.iterdir()
                if entry.is_dir() and entry.name != self._fingerprint
            ]
        except OSError:
            return
        if len(others) < MAX_FINGERPRINTS:
            return
        others.sort(key=lambda entry: entry.stat().st_mtime)
        for entry in others[: len(others) - (MAX_FINGERPRINTS - 1)]:
            logger.info("pruning stale packed-tile cache %s", entry)
            shutil.rmtree(entry, ignore_errors=True)
