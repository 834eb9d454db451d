"""Device compute kernels: tiled brute-force pair counting and clustering.

This package replaces the reference's native compute core (scipy kd-trees,
treecorr kmeans, scipy ``vq``; see /root/reference/src/yaw/catalog/trees.py
and catalog.py) with device-native JAX/Pallas implementations:

- :mod:`tiles`      — spatially sorted, padded point tiles (the device
                      layout replacing per-patch kd-trees)
- :mod:`linkage`    — patch- and tile-level pair pruning by bounding caps
                      (the dual-tree prune, applied at tile granularity)
- :mod:`thresholds` — per-redshift-bin angular edges and chord-distance
                      threshold tables, including scale (rweight) weighting
- :mod:`paircount`  — the pair-count engine (XLA reference path and the
                      Pallas GPU kernel) producing (patch-pair, bin, edge)
                      cumulative count tensors
- :mod:`kmeans`     — on-device spherical kmeans for patch centers
- :mod:`cpu_oracle` — float64 scipy kd-tree implementation used for
                      validation and as the CPU performance baseline
"""

from yet_another_wizz_tpu.ops.tiles import TileSet, build_tile_set
from yet_another_wizz_tpu.ops.linkage import Linkage, TilePairs, build_linkage
from yet_another_wizz_tpu.ops.thresholds import AngularEdges, build_angular_edges
from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles

__all__ = [
    "AngularEdges",
    "Linkage",
    "TilePairs",
    "TileSet",
    "build_angular_edges",
    "build_linkage",
    "build_tile_set",
    "count_pairs_tiles",
]
