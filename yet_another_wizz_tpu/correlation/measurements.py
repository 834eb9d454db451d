"""Cross- and autocorrelation measurement functions.

Capability parity with the reference ``yaw.correlation.measurements``
(/root/reference/src/yaw/correlation/measurements.py:65-794):
:func:`autocorrelate`, :func:`crosscorrelate` and their scalar-field
variants, patch-consistency checks, the :class:`PatchLinkage` scheduling
helper, and assembly of per-scale :class:`~yet_another_wizz_tpu.CorrFunc`
containers including the autocorrelation conventions (same-patch counts
halved, only ordered patch pairs with ``id2 >= id1``).

Execution model: instead of farming patch pairs to CPU workers over
kd-trees, the linked patch grid is expanded into a tile-pair list and
pushed through the device pair-count engine in one shot
(:mod:`yet_another_wizz_tpu.ops`); results come back as a cumulative
(slot, bin, edge) tensor that is mapped to per-scale patch-pair count
tensors on the host in float64.
"""

from __future__ import annotations

import contextlib
import logging
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu.catalog.catalog import Catalog, InconsistentPatchesError
from yet_another_wizz_tpu.correlation.corrfunc import CorrFunc, ScalarCorrFunc
from yet_another_wizz_tpu.correlation.paircounts import (
    NormalisedCounts,
    NormalisedScalarCounts,
    PatchedCounts,
    PatchedSumWeights,
)
from yet_another_wizz_tpu.ops.linkage import Linkage, build_linkage, build_tile_pairs
from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu.ops.thresholds import AngularEdges, build_angular_edges

if TYPE_CHECKING:
    from yet_another_wizz_tpu.config import Configuration

__all__ = [
    "PatchLinkage",
    "autocorrelate",
    "autocorrelate_scalar",
    "crosscorrelate",
    "crosscorrelate_scalar",
]

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _measurement_cache(max_resident_patches):
    """Measurement-scoped tile cache when the blocked path is active:
    the count types of one measurement share their packed/uploaded patch
    blocks (see
    :func:`yet_another_wizz_tpu.correlation.blocked.measurement_tile_cache`);
    yields None for the in-memory engine path."""
    if max_resident_patches is None:
        yield None
        return
    from yet_another_wizz_tpu.correlation.blocked import (
        active_tile_cache,
        measurement_tile_cache,
    )

    ambient = active_tile_cache()
    if ambient is not None:
        # a caller-held cache spans this measurement: blocks (and their
        # device-resident uploads) are shared across all measurements
        # inside the context (e.g. one reference catalog reused by every
        # tomographic bin's cross-correlation)
        yield ambient
        return
    with measurement_tile_cache() as cache:
        yield cache

LINKAGE_SLACK = 1.0 + 1e-9
"""Relative slack on the linkage cutoff so pairs exactly at the maximum
angular scale are never pruned."""


def _preferred_tile_layout(
    catalog, num_bins: int, edges, *, equal_bin_counting: bool
) -> str:
    """Measurement-facing shim over
    :func:`yet_another_wizz_tpu.ops.tiles.preferred_tile_layout` (see there
    for the zmajor-vs-spatial policy rationale) that extracts the maximum
    angle from a threshold-edge table."""
    from yet_another_wizz_tpu.ops.tiles import preferred_tile_layout

    return preferred_tile_layout(
        catalog, num_bins, edges.max_angle if num_bins > 0 else 0.0,
        equal_bin_counting=equal_bin_counting,
    )


def check_patch_consistency(catalog: Catalog, *catalogs: Catalog, rtol: float = 0.5):
    """Verify that all catalogs share (approximately) the same patch
    centers, within ``rtol`` times the patch radius."""
    centers = catalog.get_centers()
    radii = catalog.get_radii()
    for other in catalogs:
        if other.num_patches != catalog.num_patches:
            raise InconsistentPatchesError("patch IDs do not match")
        distance = centers.distance(other.get_centers())
        if np.any(distance.data / np.maximum(radii.data, 1e-12) > rtol):
            raise InconsistentPatchesError("patch centers are not aligned")


def ensure_unique_catalogs(*catalogs: Catalog | None) -> None:
    """Each catalog instance may appear only once per measurement (the
    reference enforces distinct cache directories; in-memory catalogs are
    compared by identity)."""
    seen = [cat for cat in catalogs if cat is not None]
    if len({id(cat) for cat in seen}) != len(seen):
        raise ValueError(
            "each catalog must be a separate instance to avoid interference"
        )


class PatchLinkage:
    """Patch-pair pruning shared by all pair counts of one measurement.

    Bundles the measurement configuration, the per-bin angular edge tables
    and the patch-level linkage computed from the largest input catalog.
    """

    def __init__(
        self,
        config: Configuration,
        edges: AngularEdges,
        linkage: Linkage,
    ) -> None:
        self.config = config
        self.edges = edges
        self.linkage = linkage
        logger.debug(
            "created patch linkage with %d patch pairs", self.num_links
        )

    @classmethod
    def from_catalogs(
        cls,
        config: Configuration,
        catalog: Catalog,
        *catalogs: Catalog,
    ) -> PatchLinkage:
        """Build the linkage: angular edge tables at the bin centers, patch
        geometry from the best-constrained (largest) catalog, and the cap
        cutoff at the largest angular scale."""
        edges = build_angular_edges(
            config.scales.scales,
            config.binning.binning.mids,
            config.cosmology,
            weight_scale=config.scales.rweight,
            weight_res=config.scales.resolution,
            counting=getattr(config.scales, "counting", "auto"),
        )
        logger.debug(
            "computing patch linkage with max. separation of %.2e rad",
            edges.max_angle,
        )

        ref_cat, *others = sorted(
            [catalog, *catalogs],
            key=lambda cat: sum(cat.get_num_records()),
            reverse=True,
        )
        check_patch_consistency(ref_cat, *others)

        linkage = build_linkage(
            ref_cat.patch_centers_xyz,
            ref_cat.patch_radii,
            edges.max_angle * LINKAGE_SLACK,
        )
        return cls(config, edges, linkage)

    @property
    def num_total(self) -> int:
        """Number of patch pairs without the angular cutoff."""
        return self.linkage.num_patches ** 2

    @property
    def num_links(self) -> int:
        """Number of linked patch pairs."""
        return self.linkage.num_links

    @property
    def density(self) -> float:
        """Fraction of patch pairs that are linked."""
        return self.linkage.density

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_links={self.num_links}, "
            f"density={self.density:.0%})"
        )

    def count_pairs(
        self,
        main_catalog: Catalog,
        *optional_catalog: Catalog,
        mode: str = "nn",
        binned2: bool | None = None,
        backend: str = "auto",
        max_resident_patches: int | None = None,
        progress: bool = False,
        max_workers: int | None = None,
        count_type_info: str | None = None,
        audit: bool = False,
        mesh=None,
        data_sharding: str = "replicated",
        _defer: bool = False,
        _tile_cache=None,
    ) -> list[NormalisedCounts]:
        """Count pairs between two catalogs (or within one for an
        autocorrelation), one :class:`NormalisedCounts` per scale.

        ``binned2`` controls whether the second catalog is resolved into
        redshift bins (requiring equal bins on both sides of a pair); by
        default only autocorrelations bin both sides, mirroring the
        reference's binned/unbinned tree building.

        ``_defer`` (internal) returns a zero-argument callable producing
        the result instead: the device work is queued immediately, the
        host-side fetch and post-processing happen at call time — used by
        the measurement functions to overlap the transfers of one count
        type with the queued device compute of the next.

        ``max_workers`` bounds the HOST worker pools this count creates
        (the float64 ``oracle`` backend processes, audit recomputation,
        parallel cache reads) — device-side parallelism is controlled by
        ``mesh``/``data_sharding`` instead. The reference's knob bounds
        its CPU counting pool (/root/reference/src/yaw/utils/parallel.py:53-85).
        """
        from yet_another_wizz_tpu.utils.misc import thread_limit

        if count_type_info is not None:
            logger.info("counting %s from patch pairs", count_type_info)

        auto = len(optional_catalog) == 0
        catalog1 = main_catalog
        catalog2 = main_catalog if auto else optional_catalog[0]
        if binned2 is None:
            binned2 = auto

        if max_resident_patches is not None:
            with thread_limit(max_workers):
                counts, sum_weights = self._run_blocked(
                    catalog1, catalog2, auto=auto, binned2=binned2,
                    mode=mode, backend=backend,
                    max_resident_patches=max_resident_patches,
                    mesh=mesh, data_sharding=data_sharding,
                    progress=progress, tile_cache=_tile_cache, audit=audit,
                )
            result = [
                NormalisedCounts(per_scale, sum_weights)
                for per_scale in counts
            ]
            return (lambda: result) if _defer else result

        with thread_limit(max_workers):
            finalize_engine = self._run_engine(
                catalog1, catalog2, auto=auto, binned2=binned2, mode=mode,
                backend=backend, audit=audit, mesh=mesh,
                data_sharding=data_sharding, defer=True,
            )

        def finish() -> list[NormalisedCounts]:
            with thread_limit(max_workers):
                counts, sum_weights = finalize_engine()
            return [
                NormalisedCounts(per_scale, sum_weights)
                for per_scale in counts
            ]

        return finish if _defer else finish()

    def count_pairs_optional(
        self,
        main_catalog: Catalog | None,
        *optional_catalog: Catalog | None,
        **kwargs,
    ) -> list[NormalisedCounts | None]:
        """Like :meth:`count_pairs` but propagates missing catalogs."""
        if any(cat is None for cat in (main_catalog, *optional_catalog)):
            result = [None] * self.config.scales.num_scales
            return (lambda: result) if kwargs.get("_defer") else result
        return self.count_pairs(main_catalog, *optional_catalog, **kwargs)

    def count_scalar_pairs(
        self,
        main_catalog: Catalog,
        *optional_catalog: Catalog,
        mode: str = "kn",
        **kwargs,
    ) -> list[NormalisedScalarCounts]:

        """Scalar-field pair counts: the requested kappa mode normalised by
        a plain number-count pass.

        Both passes are queued on the device before either result is
        fetched (the same defer/finalize overlap the measurement
        functions use across count types)."""
        outer_defer = kwargs.pop("_defer", False)
        count_type_info = kwargs.pop("count_type_info", None)
        kappa_deferred = self.count_pairs(
            main_catalog, *optional_catalog, mode=mode, **kwargs,
            count_type_info=count_type_info, _defer=True,
        )
        number_deferred = self.count_pairs(
            main_catalog, *optional_catalog, mode="nn", **kwargs,
            count_type_info=(
                None if count_type_info is None
                else f"{count_type_info} normalisation (nn)"
            ),
            _defer=True,
        )

        def finish() -> list[NormalisedScalarCounts]:
            return [
                NormalisedScalarCounts(kk.counts, nn.counts)
                for kk, nn in zip(kappa_deferred(), number_deferred())
            ]

        return finish if outer_defer else finish()

    def _run_blocked(
        self, catalog1, catalog2, *, auto, binned2, mode, backend,
        max_resident_patches, mesh=None, data_sharding="replicated",
        progress=False, tile_cache=None, audit=False,
    ):
        """Device-memory-bounded path: stream patch blocks through the
        engine (see :mod:`yet_another_wizz_tpu.correlation.blocked`)."""
        from yet_another_wizz_tpu.correlation.blocked import (
            count_pairs_blocked,
        )

        binning = self.config.binning.binning
        num_bins = len(binning)
        per_scale = count_pairs_blocked(
            self.edges,
            self.linkage,
            catalog1,
            catalog2,
            binning,
            auto=auto,
            binned2=binned2,
            mode=mode,
            max_resident_patches=max_resident_patches,
            backend=backend,
            mesh=mesh,
            data_sharding=data_sharding,
            progress=progress,
            cache=tile_cache,
            audit=audit,
        )
        counts = [
            PatchedCounts(binning, scale_counts, auto=auto)
            for scale_counts in per_scale
        ]
        sum_weights = PatchedSumWeights(
            binning,
            catalog1.bin_sum_weights(binning, num_bins),
            catalog2.bin_sum_weights(binning if binned2 else None, num_bins),
            auto=auto,
        )
        return counts, sum_weights

    def _build_engine_inputs(self, catalog1, catalog2, *, auto, binned2, mode):
        """The tile sets and pruned tile-pair list exactly as the engine
        will process them (layout choice and per-tile pruning included)."""
        binning = self.config.binning.binning
        num_bins = len(binning)

        tiles1 = catalog1.get_tiles(
            binning, mode=mode[0],
            layout=_preferred_tile_layout(
                catalog1, num_bins, self.edges, equal_bin_counting=binned2
            ),
        )
        tiles2 = catalog2.get_tiles(
            binning if binned2 else None, mode=mode[1],
            layout=(
                _preferred_tile_layout(
                    catalog2, num_bins, self.edges, equal_bin_counting=True
                )
                if binned2
                else "spatial"
            ),
        )

        pairs = build_tile_pairs(
            tiles1, tiles2, self.linkage, auto=auto,
            bin_max_angles=self.edges.edges.max(axis=1),
        )
        return tiles1, tiles2, pairs

    def num_candidate_pairs(
        self,
        catalog1: Catalog,
        catalog2: Catalog | None = None,
        *,
        binned2: bool | None = None,
        mode: str = "nn",
    ) -> int:
        """Candidate pairs the engine actually evaluates for this count:
        ``num_tile_pairs * tile_size**2`` of the SAME pruned tile-pair list
        the measurement processes (tile layout choice and per-tile
        redshift-bin pruning included) — the honest work statistic for
        throughput reporting."""
        stats = self.engine_work_stats(
            catalog1, catalog2, binned2=binned2, mode=mode
        )
        return stats["candidate_pairs"]

    def engine_work_stats(
        self,
        catalog1: Catalog,
        catalog2: Catalog | None = None,
        *,
        binned2: bool | None = None,
        mode: str = "nn",
    ) -> dict:
        """Work statistics of one count for performance models:
        ``candidate_pairs`` as in :meth:`num_candidate_pairs`,
        ``slot_transitions`` (changes of the output slot along the
        slot-sorted tile-pair list) and ``fetch_bytes``
        (the float32 ``(num_slots, B, E)`` result tensor the host fetches
        from the device)."""
        auto = catalog2 is None
        if binned2 is None:
            binned2 = auto
        tiles1, _, pairs = self._build_engine_inputs(
            catalog1, catalog1 if auto else catalog2,
            auto=auto, binned2=binned2, mode=mode,
        )
        transitions = 0
        if pairs.num_pairs:
            transitions = int(np.count_nonzero(np.diff(pairs.slot) != 0)) + 1
        num_bins = len(self.config.binning.binning)
        num_edges = self.edges.num_counting_edges
        return {
            "candidate_pairs": int(pairs.num_pairs) * tiles1.tile_size ** 2,
            "slot_transitions": transitions,
            "fetch_bytes": int(pairs.num_slots) * num_bins * num_edges * 4,
        }

    def _run_engine(
        self, catalog1, catalog2, *, auto, binned2, mode, backend="auto",
        audit=False, mesh=None, data_sharding="replicated", defer=False,
    ):
        binning = self.config.binning.binning
        num_bins = len(binning)
        num_patches = catalog1.num_patches

        tiles1, tiles2, pairs = self._build_engine_inputs(
            catalog1, catalog2, auto=auto, binned2=binned2, mode=mode
        )
        logger.debug(
            "processing %d tile pairs in %d patch pairs",
            pairs.num_pairs,
            pairs.num_slots,
        )
        # direct separation-weighted counting when the edge tables carry
        # it — except when exactness demands the union-edge cumulative
        # representation (the float64 oracle backend and the boundary
        # audit; both formulations are mathematically identical in
        # float64, see ops.thresholds.DirectEdges)
        direct = self.edges.direct
        if direct is not None and not audit and backend != "oracle":
            table = direct.combined_table()
            edges_radian = direct.edges
            direct_spec = direct.spec
            mapper = direct
        else:
            table = self.edges.chord2_table
            edges_radian = self.edges.edges
            direct_spec = None
            mapper = self.edges

        # with defer=True the engine result may come back as an in-flight
        # device array; the host-side post-processing moves into finalize()
        # so queued device work for later counts overlaps it
        cumulative = count_pairs_tiles(
            tiles1, tiles2, pairs, table,
            backend=backend, edges_radian=edges_radian, audit=audit,
            mesh=mesh, data_sharding=data_sharding, defer=defer,
            direct=direct_spec,
        )

        def finalize():
            import jax

            values = cumulative
            if not isinstance(values, np.ndarray):
                values = np.asarray(jax.device_get(values), dtype=np.float64)
            per_scale = mapper.counts_to_scales(values)  # (S, slots, B)

            slot_ids1 = pairs.slot_patches[:, 0]
            slot_ids2 = pairs.slot_patches[:, 1]
            if auto:
                same = slot_ids1 == slot_ids2
                per_scale[:, same, :] *= 0.5  # ordered pairs double-count

            counts = []
            for scale_values in per_scale:
                patched = PatchedCounts.zeros(binning, num_patches, auto=auto)
                patched.counts[:, slot_ids1, slot_ids2] = scale_values.T
                counts.append(patched)

            sum_weights = PatchedSumWeights(
                binning,
                tiles1.bin_sum_weights(num_bins),
                tiles2.bin_sum_weights(num_bins),
                auto=auto,
            )
            return counts, sum_weights

        return finalize if defer else finalize()


def autocorrelate(
    config: Configuration,
    data: Catalog,
    random: Catalog,
    *,
    count_rr: bool = True,
    backend: str = "auto",
    max_resident_patches: int | None = None,
    progress: bool = False,
    max_workers: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[CorrFunc]:
    """Measure the angular autocorrelation amplitude of a catalog in bins
    of redshift.

    Returns one :class:`CorrFunc` per configured scale, holding DD, DR and
    (optionally) RR pair counts; with RR present the Landy-Szalay estimator
    becomes available.
    """
    ensure_unique_catalogs(data, random)
    kwargs = dict(
        progress=progress, max_workers=max_workers, backend=backend,
        max_resident_patches=max_resident_patches, audit=audit,
        mesh=mesh, data_sharding=data_sharding,
    )

    logger.info(
        "computing auto-correlation from DD, DR%s", ", RR" if count_rr else ""
    )
    links = PatchLinkage.from_catalogs(config, data, random)
    logger.debug(
        "using %d scales %s weighting",
        config.scales.num_scales,
        "with" if config.scales.rweight else "without",
    )

    # queue all count types on the device first, then finalize in order:
    # each count's result transfer and host post-processing overlap the
    # queued device compute of the following counts
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_pairs(
            data, **kwargs, count_type_info="DD", _defer=True
        )
        # data x random pairs are counted between matching redshift bins
        # on both sides, like the reference's binned random trees
        dr = links.count_pairs(
            data, random, binned2=True, **kwargs, count_type_info="DR",
            _defer=True,
        )
        optional_random = random if count_rr else None
        rr = links.count_pairs_optional(
            optional_random, **kwargs, count_type_info="RR", _defer=True
        )
        dd, dr, rr = dd(), dr(), rr()
    return [CorrFunc(a, b, None, c) for a, b, c in zip(dd, dr, rr)]


def crosscorrelate(
    config: Configuration,
    reference: Catalog,
    unknown: Catalog,
    *,
    ref_rand: Catalog | None = None,
    unk_rand: Catalog | None = None,
    backend: str = "auto",
    max_resident_patches: int | None = None,
    progress: bool = False,
    max_workers: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[CorrFunc]:
    """Measure the angular cross-correlation amplitude between the unknown
    sample and redshift slices of the reference sample.

    At least one random catalog is required; with both randoms present RR
    is counted and the Landy-Szalay estimator becomes available. Returns
    one :class:`CorrFunc` per configured scale.
    """
    ensure_unique_catalogs(reference, unknown, ref_rand, unk_rand)
    count_dr = unk_rand is not None
    count_rd = ref_rand is not None
    if not count_dr and not count_rd:
        raise ValueError("at least one random dataset must be provided")

    kwargs = dict(
        progress=progress, max_workers=max_workers, backend=backend,
        max_resident_patches=max_resident_patches, audit=audit,
        mesh=mesh, data_sharding=data_sharding,
    )
    logger.info(
        "computing cross-correlation from DD%s%s%s",
        ", DR" if count_dr else "",
        ", RD" if count_rd else "",
        ", RR" if (count_dr and count_rd) else "",
    )

    catalogs = [cat for cat in (ref_rand, unk_rand) if cat is not None]
    links = PatchLinkage.from_catalogs(config, reference, unknown, *catalogs)
    logger.debug(
        "using %d scales %s weighting",
        config.scales.num_scales,
        "with" if config.scales.rweight else "without",
    )

    # queue all count types, then finalize in order (fetch/post-processing
    # of earlier counts overlaps the queued device compute of later ones)
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_pairs(
            reference, unknown, **kwargs, count_type_info="DD", _defer=True
        )
        dr = links.count_pairs_optional(
            reference, unk_rand, **kwargs, count_type_info="DR", _defer=True
        )
        rd = links.count_pairs_optional(
            ref_rand, unknown, **kwargs, count_type_info="RD", _defer=True
        )
        rr = links.count_pairs_optional(
            ref_rand, unk_rand, **kwargs, count_type_info="RR", _defer=True
        )
        dd, dr, rd, rr = dd(), dr(), rd(), rr()
    return [CorrFunc(a, b, c, d) for a, b, c, d in zip(dd, dr, rd, rr)]


def compute_scalar_normalisation(
    catalog: Catalog, config: Configuration
) -> NormalisedScalarCounts:
    """Normalisation for scalar counts from the mean kappa per patch (used
    when no randoms are provided to :func:`crosscorrelate_scalar`)."""
    binning = config.binning.binning
    tiles = catalog.get_tiles(binning, mode="n")
    if tiles.sum_kappa is None:
        raise ValueError("missing required 'kappa' values")

    num_bins, num_patches = tiles.sum_kappa.shape
    sum_kappa = np.zeros((num_bins, num_patches, num_patches))
    sum_weights = np.zeros_like(sum_kappa)
    diag = np.arange(num_patches)
    sum_kappa[:, diag, diag] = tiles.sum_kappa
    sum_weights[:, diag, diag] = tiles.sum_weights

    return NormalisedScalarCounts(
        PatchedCounts(binning, sum_kappa, auto=False),
        PatchedCounts(binning, sum_weights, auto=False),
    )


def autocorrelate_scalar(
    config: Configuration,
    data: Catalog,
    *,
    backend: str = "auto",
    progress: bool = False,
    max_workers: int | None = None,
    max_resident_patches: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[ScalarCorrFunc]:
    """Measure the angular autocorrelation amplitude of a scalar (kappa)
    field in bins of redshift.

    Accepts the same execution options as :func:`autocorrelate`
    (``mesh``/``data_sharding`` for multi-device runs, ``audit`` for the
    exact-boundary float64 repair, ``max_resident_patches`` for the
    memory-bounded blocked path)."""
    logger.info("computing scalar auto-correlation with DD")
    links = PatchLinkage.from_catalogs(config, data)
    with _measurement_cache(max_resident_patches) as tile_cache:
        dd = links.count_scalar_pairs(
            data, mode="kk", backend=backend, progress=progress,
            max_workers=max_workers, audit=audit, mesh=mesh,
            data_sharding=data_sharding,
            max_resident_patches=max_resident_patches,
            count_type_info="DD", _tile_cache=tile_cache,
        )
    return [ScalarCorrFunc(counts) for counts in dd]


def crosscorrelate_scalar(
    config: Configuration,
    reference: Catalog,
    unknown: Catalog,
    *,
    unk_rand: Catalog | None = None,
    backend: str = "auto",
    progress: bool = False,
    max_workers: int | None = None,
    max_resident_patches: int | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
) -> list[ScalarCorrFunc]:
    """Measure the angular cross-correlation amplitude between a scalar
    (kappa) field carried by the REFERENCE sample and the unknown sample
    (the reference's ``crosscorrelate_scalar`` semantics: counting mode
    ``kn`` weights the redshift-binned reference side by kappa * weight,
    /root/reference/src/yaw/correlation/measurements.py:709-800).

    Without unknown randoms the counts are normalised by the mean kappa
    over the footprint instead of a DR term.

    Accepts the same execution options as :func:`crosscorrelate`
    (``mesh``/``data_sharding`` for multi-device runs, ``audit`` for the
    exact-boundary float64 repair, ``max_resident_patches`` for the
    memory-bounded blocked path)."""
    ensure_unique_catalogs(reference, unknown, unk_rand)
    count_dr = unk_rand is not None
    logger.info(
        "computing scalar cross-correlation with DD%s",
        ", DR" if count_dr else "",
    )

    catalogs = [cat for cat in (unk_rand,) if cat is not None]
    links = PatchLinkage.from_catalogs(config, reference, unknown, *catalogs)

    kwargs = dict(
        backend=backend, progress=progress, max_workers=max_workers,
        audit=audit, mesh=mesh, data_sharding=data_sharding,
        max_resident_patches=max_resident_patches,
    )
    # queue both count types on the device before finalizing either, the
    # same defer/finalize overlap crosscorrelate applies across DD..RR
    with _measurement_cache(max_resident_patches) as tile_cache:
        kwargs["_tile_cache"] = tile_cache
        dd = links.count_scalar_pairs(
            reference, unknown, mode="kn", **kwargs, count_type_info="DD",
            _defer=True,
        )
        dr = (
            links.count_scalar_pairs(
                reference, unk_rand, mode="kn", **kwargs,
                count_type_info="DR", _defer=True,
            )
            if count_dr
            else None
        )
        dd = dd()  # finalize in queue order: fetch overlaps DR compute
        dr = (
            dr()
            if dr is not None
            else [compute_scalar_normalisation(reference, config)] * len(dd)
        )
    return [ScalarCorrFunc(a, b) for a, b in zip(dd, dr)]
