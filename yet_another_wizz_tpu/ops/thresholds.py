"""Angular-edge tables for per-redshift-bin cumulative pair counting.

The engine counts pairs cumulatively against a table of squared-chord
thresholds per (redshift bin, edge); interval counts and the mapping to the
requested scale ranges (including the optional power-law separation
weighting ``w(theta) ~ theta^alpha``) are recovered on the host in float64.

Semantics mirror the reference kernel exactly
(/root/reference/src/yaw/catalog/trees.py:84-160): per bin, the edge set is
the union of all scale limits and, when weighting is enabled, ``resolution``
logarithmically spaced sub-edges spanning the overall range; counts fall in
half-open intervals ``(edge_k, edge_{k+1}]``; sub-bin counts are scaled by
``theta_mid^alpha`` normalised over all sub-bins; scale totals sum the
sub-intervals whose edges are nearest to the scale limits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu.coordinates import angle_to_chord

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu.cosmology import Scales, TypeCosmology

__all__ = [
    "AngularEdges",
    "DirectEdges",
    "build_angular_edges",
    "validate_angle_range",
]

DIRECT_CROSSOVER = 12
"""Number of union edges above which separation-weighted counting switches
from cumulative per-edge passes to the direct per-pair-weight formulation
(the analogue of the reference's cumulative-vs-binned heuristic at 8
angular bins, /root/reference/src/yaw/catalog/trees.py:341). The device
cost of cumulative counting is ~3 elementwise passes per edge, the direct mode
replaces all sub-edge passes with a fixed ~15-pass log/exp block, so the
crossover sits where ``3 * (E_union - E_scale)`` exceeds that block."""


def validate_angle_range(ang_min: NDArray, ang_max: NDArray) -> NDArray:
    """Validate per-scale angular limits: 1-dim, matching lengths,
    ``min < max``, all within ``[0, pi]``. Returns an ``(S, 2)`` array."""
    ang_min = np.atleast_1d(np.asarray(ang_min, dtype=np.float64))
    ang_max = np.atleast_1d(np.asarray(ang_max, dtype=np.float64))

    if ang_min.ndim != 1 or ang_max.ndim != 1:
        raise ValueError("'ang_min' and 'ang_max' must be 1-dim")
    if len(ang_min) != len(ang_max):
        raise ValueError("length of 'ang_min' and 'ang_max' does not match")
    limits = np.column_stack((ang_min, ang_max))
    if not np.all(np.isfinite(limits)):
        # NaN passes every comparison check below as False and would
        # silently collapse the measurement to zero counts (NaN cutoff
        # links no patch pair)
        raise ValueError("'ang_min' and 'ang_max' must be finite")
    if np.any(ang_min >= ang_max):
        raise ValueError("'ang_min' < 'ang_max' not satisfied")
    if np.any(limits < 0.0) or np.any(limits > np.pi):
        raise ValueError("'ang_min' and 'ang_max' not in range [0.0, pi]")
    return limits


def _edges_for_limits(
    limits: NDArray, weight_scale: float | None, weight_res: int
) -> NDArray:
    """Edge set for one redshift bin: scale limits plus optional log-spaced
    sub-edges for separation weighting."""
    if weight_scale is None:
        # no log roundtrip: keeps the user's edges exact to the ulp and
        # avoids log10(0) warnings for the valid ang_min=0 case
        return np.sort(np.unique(limits.ravel()))
    log_limits = np.log10(limits)
    sub = np.linspace(log_limits.min(), log_limits.max(), weight_res + 1)
    log_edges = np.concatenate([sub, log_limits.ravel()])
    return 10.0 ** np.sort(np.unique(log_edges))


def _interval_weights(
    edges: NDArray, weight_scale: float | None
) -> NDArray:
    """Per-interval multiplicative weights from the power-law separation
    weighting (all ones when disabled)."""
    if weight_scale is None:
        return np.ones(len(edges) - 1)
    log_edges = np.log10(edges)
    mids = 10.0 ** (0.5 * (log_edges[:-1] + log_edges[1:]))
    w = mids**weight_scale
    return w / w.sum()


def _scale_map(edges: NDArray, limits: NDArray, weights: NDArray) -> NDArray:
    """Matrix ``(num_intervals, S)`` mapping weighted interval counts to the
    requested scale ranges (nearest-edge selection)."""
    num_intervals = len(edges) - 1
    mapping = np.zeros((num_intervals, len(limits)))
    for s, (lo, hi) in enumerate(limits):
        idx_lo = int(np.argmin(np.abs(edges - lo)))
        idx_hi = int(np.argmin(np.abs(edges - hi)))
        mapping[idx_lo:idx_hi, s] = weights[idx_lo:idx_hi]
    return mapping


@dataclass
class DirectEdges:
    """Device tables for the direct separation-weighted counting mode.

    Instead of counting cumulatively at every union edge (scale limits
    plus ``resolution`` log sub-edges — O(E) elementwise passes per tile pair),
    the kernel computes each pair's sub-interval index in O(1) from the
    uniform log grid, applies the normalised per-interval weight
    ``theta_mid^alpha / norm`` as a multiplicative pair weight, and counts
    cumulatively only at the scale-limit edges. In float64 this is
    MATHEMATICALLY IDENTICAL to the union-edge histogram the reference
    computes (/root/reference/src/yaw/catalog/trees.py:84-117,356-362):
    every pair receives the log-mid weight of its union interval and scale
    totals cut exactly at the limits. Interior scale limits that split a
    uniform sub-interval are handled exactly by the below/above adjustment
    entries. Float32 wobble moves only pairs within ~1e-6 of a sub-edge
    between neighbouring weights — the same error class as the cumulative
    mode's float32 thresholds.

    Attributes:
        chord2_table:
            float32 ``(B, E_s)`` squared-chord thresholds at the
            scale-limit edges only.
        edges:
            float64 ``(B, E_s)`` scale-limit angular edges.
        scale_maps:
            float64 ``(B, E_s - 1, S)``: 1 where the interval lies within
            a scale (weights and normalisation live in the device tables).
        gtable:
            float32 ``(B, 4 + 3 * (NB + NA))`` per-bin weight parameters:
            ``[inv_d, lo_scaled, gc0, gc1]`` — the pair's uniform-grid
            index is ``floor(log10(theta) * inv_d - lo_scaled)`` and its
            base weight ``exp(gc0 + gc1 * idx)`` — followed by ``NB``
            below-entries ``(k, thr_chord2, g)`` (pairs in sub-interval k
            at or below the splitting limit) and ``NA`` ascending
            above-entries ``(k, thr_chord2, g)`` (pairs above the limit).
            Unused entries carry ``k = -1``.
        num_sub:
            number of uniform log sub-intervals (the ``resolution``).
        num_below / num_above:
            static adjustment-entry counts (max over bins, padded).
    """

    chord2_table: NDArray
    edges: NDArray
    scale_maps: NDArray
    gtable: NDArray
    num_sub: int
    num_below: int
    num_above: int

    @property
    def spec(self) -> tuple[int, int, int, bool]:
        """Static kernel configuration ``(num_sub, num_below, num_above,
        small_angle)``. ``small_angle`` selects the cheaper sqrt/arcsine-
        free index evaluation when every counting edge sits within the
        fitted range (:data:`yet_another_wizz_tpu.ops.gweight.THETA_POLY_MAX`);
        pairs beyond the edges cannot reach any output, so only the
        in-grid range needs the polynomial's accuracy."""
        from yet_another_wizz_tpu.ops.gweight import THETA_POLY_MAX

        small_angle = bool(float(np.max(self.edges)) <= THETA_POLY_MAX)
        return (self.num_sub, self.num_below, self.num_above, small_angle)

    def counts_to_scales(self, cumulative: NDArray) -> NDArray:
        """Convert cumulative scale-edge counts ``(..., B, E_s)`` into
        per-scale counts ``(S, ..., B)`` in float64 (the weights and
        normalisation are already applied per pair on the device)."""
        cumulative = np.asarray(cumulative, dtype=np.float64)
        intervals = np.diff(cumulative, axis=-1)
        return np.einsum("...bk,bks->s...b", intervals, self.scale_maps)

    def combined_table(self) -> NDArray:
        """float32 ``(B, E_s + C)``: counting thresholds with the weight
        parameters appended — the single per-bin table the kernels select
        per row via one-hot."""
        return np.concatenate(
            [self.chord2_table, self.gtable], axis=1
        ).astype(np.float32)


@dataclass
class AngularEdges:
    """Per-redshift-bin angular edges, chord thresholds and scale mapping.

    Attributes:
        chord2_table:
            float32 ``(B, E)`` squared-chord thresholds (per-bin edge sets
            padded to the widest bin by repeating the last edge, which
            creates empty intervals).
        edges:
            float64 ``(B, E)`` angular edges (same padding).
        scale_maps:
            float64 ``(B, E - 1, S)`` interval-to-scale mapping including
            separation weights; padded intervals map to zero.
        max_angle:
            largest angular edge over all bins (the linkage cutoff).
        direct:
            optional :class:`DirectEdges` tables for the direct
            separation-weighted counting mode (built for weighted
            configurations with many union edges; the engine uses them
            unless exactness — oracle backend or the boundary audit —
            requires the union-edge cumulative representation).
    """

    chord2_table: NDArray
    edges: NDArray
    scale_maps: NDArray
    max_angle: float
    direct: DirectEdges | None = None

    @property
    def num_bins(self) -> int:
        return self.edges.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[1]

    @property
    def num_counting_edges(self) -> int:
        """Width of the engine's output edge axis: all union edges in
        cumulative mode, only the scale-limit edges in direct mode."""
        if self.direct is not None:
            return self.direct.edges.shape[1]
        return self.num_edges

    @property
    def num_scales(self) -> int:
        return self.scale_maps.shape[2]

    def counts_to_scales(self, cumulative: NDArray) -> NDArray:
        """Convert cumulative counts ``(..., B, E)`` into per-scale counts
        ``(S, ..., B)`` in float64."""
        cumulative = np.asarray(cumulative, dtype=np.float64)
        intervals = np.diff(cumulative, axis=-1)  # (..., B, E-1)
        # sum_k intervals[..., b, k] * scale_maps[b, k, s]
        scales = np.einsum("...bk,bks->s...b", intervals, self.scale_maps)
        return scales


def _direct_bin_params(
    limits: NDArray, weight_scale: float, weight_res: int
) -> tuple:
    """Direct-mode parameters for one redshift bin (see
    :class:`DirectEdges`): scale-limit edges, grid/weight coefficients and
    the below/above adjustment entries for interior limits.

    All weights come from the SAME union-interval log-mids the cumulative
    representation uses (:func:`_interval_weights`), so the two
    formulations agree exactly in float64.
    """
    log_limits = np.log10(limits)
    lo, hi = log_limits.min(), log_limits.max()
    delta = (hi - lo) / weight_res
    uniform = np.linspace(lo, hi, weight_res + 1)
    union_log = np.sort(np.unique(np.concatenate([uniform, log_limits.ravel()])))

    # normalised union-interval weights, replicating _interval_weights
    log_mids = 0.5 * (union_log[:-1] + union_log[1:])
    w_raw = (10.0 ** log_mids) ** weight_scale
    w_sum = w_raw.sum()
    w_union = w_raw / w_sum

    ln10 = np.log(10.0)
    inv_d = 1.0 / delta
    lo_scaled = lo * inv_d
    gc1 = weight_scale * delta * ln10
    gc0 = weight_scale * (lo + 0.5 * delta) * ln10 - np.log(w_sum)

    # interior limits: strictly inside the range and not on the uniform
    # grid (exact float comparison, mirroring np.unique's dedup)
    interior = sorted(
        {
            l for l in log_limits.ravel()
            if lo < l < hi and not np.any(uniform == l)
        }
    )
    below = []  # one per split uniform interval: its lowest piece
    above = []  # one per interior limit, ascending
    seen_intervals = set()
    for l in interior:
        k = int(np.searchsorted(uniform, l) - 1)
        j = int(np.searchsorted(union_log, l))  # index of l in union_log
        thr = float(
            np.float32(angle_to_chord(np.float64(10.0 ** l)) ** 2)
        )
        if k not in seen_intervals:
            seen_intervals.add(k)
            below.append((float(k), thr, float(w_union[j - 1])))
        above.append((float(k), thr, float(w_union[j])))

    scale_edges = 10.0 ** np.unique(log_limits.ravel())
    coeffs = (float(inv_d), float(lo_scaled), float(gc0), float(gc1))
    return scale_edges, coeffs, below, above


def _build_direct(
    per_bin_limits: list, weight_scale: float, weight_res: int
) -> DirectEdges:
    """Assemble the padded per-bin :class:`DirectEdges` tables."""
    num_bins = len(per_bin_limits)
    params = [
        _direct_bin_params(limits, weight_scale, weight_res)
        for limits in per_bin_limits
    ]
    num_scales = len(per_bin_limits[0])
    max_edges = max(len(p[0]) for p in params)
    num_below = max(len(p[2]) for p in params)
    num_above = max(len(p[3]) for p in params)

    edges = np.empty((num_bins, max_edges))
    scale_maps = np.zeros((num_bins, max_edges - 1, num_scales))
    gtable = np.zeros((num_bins, 4 + 3 * (num_below + num_above)))
    for b, (limits, (sc_edges, coeffs, below, above)) in enumerate(
        zip(per_bin_limits, params)
    ):
        edges[b, : len(sc_edges)] = sc_edges
        edges[b, len(sc_edges):] = sc_edges[-1]
        ones = np.ones(len(sc_edges) - 1)
        m = _scale_map(sc_edges, limits, ones)
        scale_maps[b, : m.shape[0], :] = m
        gtable[b, :4] = coeffs
        col = 4
        for entries, count in ((below, num_below), (above, num_above)):
            padded = list(entries) + [(-1.0, 0.0, 0.0)] * (
                count - len(entries)
            )
            for k, thr, g in padded:
                gtable[b, col : col + 3] = (k, thr, g)
                col += 3

    chord2 = angle_to_chord(edges) ** 2
    return DirectEdges(
        chord2_table=chord2.astype(np.float32),
        edges=edges,
        scale_maps=scale_maps,
        gtable=gtable.astype(np.float32),
        num_sub=weight_res,
        num_below=num_below,
        num_above=num_above,
    )


def build_angular_edges(
    scales: Scales,
    zmids: NDArray,
    cosmology: TypeCosmology | None = None,
    *,
    weight_scale: float | None = None,
    weight_res: int = 50,
    counting: str = "auto",
) -> AngularEdges:
    """Build the per-bin edge tables for a set of correlation scales.

    The scale limits are converted to angles at each redshift-bin center
    (mirroring /root/reference/src/yaw/correlation/measurements.py:110-112).

    ``counting`` selects the device formulation for separation-weighted
    configurations: ``cumulative`` (union-edge passes only), ``direct``
    (force the :class:`DirectEdges` tables), or ``auto`` (build them when
    the union edge count reaches :data:`DIRECT_CROSSOVER` — the analogue
    of the reference's heuristic at
    /root/reference/src/yaw/catalog/trees.py:341).
    """
    if counting not in ("auto", "cumulative", "direct"):
        raise ValueError(f"unknown counting mode '{counting}'")
    if counting == "direct" and weight_scale is None:
        raise ValueError(
            "counting='direct' requires separation weighting "
            "('weight_scale'); without sub-edges it is identical to "
            "'cumulative'"
        )
    zmids = np.atleast_1d(np.asarray(zmids, dtype=np.float64))

    per_bin_edges = []
    per_bin_maps = []
    per_bin_limits = []
    for z in zmids:
        ang_min, ang_max = scales.get_angle_radian(z, cosmology=cosmology)
        limits = validate_angle_range(ang_min, ang_max)
        if weight_scale is not None and np.any(limits <= 0.0):
            # the log-spaced sub-edge grid (and the direct-mode
            # coefficients) work in log10(theta): a zero lower limit
            # would silently turn every weighted count into NaN
            raise ValueError(
                "separation weighting requires strictly positive "
                f"angular limits, got ang_min=0 at z={z:.4g}"
            )
        edges = _edges_for_limits(limits, weight_scale, weight_res)
        weights = _interval_weights(edges, weight_scale)
        per_bin_edges.append(edges)
        per_bin_maps.append(_scale_map(edges, limits, weights))
        per_bin_limits.append(limits)

    num_scales = per_bin_maps[0].shape[1]
    max_edges = max(len(e) for e in per_bin_edges)
    num_bins = len(zmids)

    edges = np.empty((num_bins, max_edges))
    scale_maps = np.zeros((num_bins, max_edges - 1, num_scales))
    for b, (e, m) in enumerate(zip(per_bin_edges, per_bin_maps)):
        edges[b, : len(e)] = e
        edges[b, len(e) :] = e[-1]  # padded edges yield empty intervals
        scale_maps[b, : m.shape[0], :] = m

    direct = None
    if weight_scale is not None and (
        counting == "direct"
        or (counting == "auto" and max_edges >= DIRECT_CROSSOVER)
    ):
        direct = _build_direct(per_bin_limits, weight_scale, weight_res)

    chord2 = angle_to_chord(edges) ** 2
    return AngularEdges(
        chord2_table=chord2.astype(np.float32),
        edges=edges,
        scale_maps=scale_maps,
        max_angle=float(edges.max()),
        direct=direct,
    )
