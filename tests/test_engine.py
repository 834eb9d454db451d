"""Validation of the tiled pair-count engine against the float64 kd-tree
oracle and against analytically constructed point sets."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from yet_another_wizz_tpu.coordinates import radec_to_xyz
from yet_another_wizz_tpu.ops.cpu_oracle import count_pairs_oracle
from yet_another_wizz_tpu.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu.ops.thresholds import (
    build_angular_edges,
    validate_angle_range,
)
from yet_another_wizz_tpu.ops.tiles import build_tile_set, morton_codes
from yet_another_wizz_tpu.cosmology import new_scales


def random_cap_catalog(rng, n, num_bins, cap_deg=20.0, weighted=True):
    """Random points in a spherical cap around (ra, dec) = (1, 0.3) rad."""
    cos_max = np.cos(np.deg2rad(cap_deg))
    mu = rng.uniform(cos_max, 1.0, n)
    theta = np.arccos(mu)
    phi = rng.uniform(0, 2 * np.pi, n)
    # local cap coordinates rotated to the cap center
    xyz_local = np.column_stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), mu]
    )
    # rotate z-axis onto the cap center
    center = radec_to_xyz([1.0], [0.3])[0]
    z_axis = np.array([0.0, 0.0, 1.0])
    v = np.cross(z_axis, center)
    s, c = np.linalg.norm(v), np.dot(z_axis, center)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    rot = np.eye(3) + vx + vx @ vx * ((1 - c) / s**2)
    xyz = xyz_local @ rot.T
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)

    weights = rng.uniform(0.5, 2.0, n) if weighted else np.ones(n)
    zbins = rng.integers(0, num_bins, n)
    return xyz, weights, zbins


def simple_patches(xyz, num_patches, rng):
    """Assign patches by nearest random center (deterministic given rng)."""
    centers = xyz[rng.choice(len(xyz), num_patches, replace=False)]
    return np.argmax(xyz @ centers.T, axis=1)


def patch_geometry(xyz, patch_ids, num_patches):
    centers = np.zeros((num_patches, 3))
    radii = np.zeros(num_patches)
    for p in range(num_patches):
        pts = xyz[patch_ids == p]
        if len(pts) == 0:
            centers[p, 0] = 1.0
            continue
        c = pts.mean(axis=0)
        c /= np.linalg.norm(c)
        centers[p] = c
        chord = np.linalg.norm(pts - c, axis=1)
        radii[p] = 2 * np.arcsin(np.min([chord.max() / 2, 1.0]))
    return centers, radii


def run_engine_vs_oracle(
    rng,
    n1=3000,
    n2=4000,
    num_bins=3,
    num_patches=5,
    cols_binned=False,
    tile_size=64,
    edges_deg=(0.2, 1.0),
    backend="xla",
    auto=False,
):
    xyz1, w1, z1 = random_cap_catalog(rng, n1, num_bins)
    if auto:
        xyz2, w2, z2 = xyz1, w1, z1
    else:
        xyz2, w2, z2 = random_cap_catalog(rng, n2, num_bins)

    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = (
        patch1 if auto else simple_patches(xyz2, num_patches, np.random.default_rng(3))
    )

    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=tile_size,
    )
    if auto:
        ts2 = ts1
    else:
        ts2 = build_tile_set(
            xyz2, patch2, num_patches, weights=w2,
            zbins=z2 if cols_binned else None,
            num_bins=num_bins if cols_binned else 0,
            tile_size=tile_size,
        )

    # same angular edges in every bin for this test
    edges = np.deg2rad(np.tile(edges_deg, (num_bins, 1)))
    chord2 = (2 * np.sin(edges / 2)) ** 2

    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=auto)

    result = count_pairs_tiles(
        ts1, ts2, pairs, chord2.astype(np.float32), backend=backend
    )
    expect = count_pairs_oracle(
        xyz1, w1, z1, patch1,
        xyz2, w2, (z2 if (cols_binned or auto) else None), patch2,
        pairs.slot_patches, edges,
    )
    return result, expect


class TestTileSet:
    def test_morton_locality(self, rng):
        xyz, _, _ = random_cap_catalog(rng, 1000, 1)
        codes = morton_codes(xyz)
        order = np.argsort(codes)
        # consecutive points in morton order should be much closer on
        # average than in random order
        sorted_d = np.linalg.norm(np.diff(xyz[order], axis=0), axis=1).mean()
        rand_d = np.linalg.norm(np.diff(xyz, axis=0), axis=1).mean()
        assert sorted_d < 0.3 * rand_d

    def test_padding_and_sums(self, rng):
        xyz, w, z = random_cap_catalog(rng, 500, 3)
        patches = simple_patches(xyz, 4, rng)
        ts = build_tile_set(
            xyz, patches, 4, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        assert ts.lane_data.shape[1:] == (8, 64)
        assert ts.num_points == 500
        # total weight channel equals true sum (padding rows are zero)
        assert_allclose(
            ts.lane_data[:, 6, :].astype(np.float64).sum(), w.sum(), rtol=1e-5
        )
        # per (bin, patch) sums
        for b in range(3):
            for p in range(4):
                sel = (z == b) & (patches == p)
                assert_allclose(ts.sum_weights[b, p], w[sel].sum(), rtol=1e-12)

    def test_out_of_range_points_dropped(self, rng):
        xyz, w, z = random_cap_catalog(rng, 300, 3)
        z = z.astype(np.int64)
        z[:50] = -1
        z[50:80] = 7
        patches = np.zeros(300, dtype=int)
        ts = build_tile_set(
            xyz, patches, 1, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        assert ts.num_points == 220
        assert_allclose(ts.sum_weights.sum(), w[80:].sum(), rtol=1e-12)

    def test_fixedpoint_encode_decode_roundtrip(self, rng):
        """Properties the link-compressed lane encoding guarantees:
        weight/zbin channels survive bit-exactly, quantisation moves each
        coordinate by at most scale/2 with scale <= max_offset/2^29, and
        the device decode is EXACT — the (hi, lo) float32 pair sums (in
        float64) to the encoded value center + q * scale up to the
        compensated-pair residual, far below the quantisation step."""
        from yet_another_wizz_tpu.ops.tiles import (
            decode_fixedpoint_lanes,
            encode_fixedpoint_lanes,
        )

        xyz, w, z = random_cap_catalog(rng, 2000, 3)
        patches = simple_patches(xyz, 5, rng)
        ts = build_tile_set(
            xyz, patches, 5, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        packed, params, zbins = encode_fixedpoint_lanes(
            ts.lane_data, ts.tile_center
        )
        decoded = np.asarray(decode_fixedpoint_lanes()(packed, params, zbins))

        # the weight lane is bit-cast and the int8 bin lane holds small
        # integers — both survive exactly
        assert np.array_equal(decoded[:, 6, :], ts.lane_data[:, 6, :])
        assert np.array_equal(decoded[:, 7, :], ts.lane_data[:, 7, :])

        original = (
            ts.lane_data[:, 0:3, :].astype(np.float64)
            + ts.lane_data[:, 3:6, :]
        )
        recovered = decoded[:, 0:3, :].astype(np.float64) + decoded[:, 3:6, :]
        scale = params[:, 6].astype(np.float64)[:, None, None]

        # the decode reproduces center + q * scale essentially exactly
        center = (
            params[:, 0:3].astype(np.float64) + params[:, 3:6]
        )[:, :, None]
        exact = center + packed[:, 0:3, :].astype(np.float64) * scale
        assert np.abs(recovered - exact).max() <= 2.0**-40

        # quantisation error bounded by half a step per axis
        err = np.abs(recovered - original)
        assert np.all(err <= 0.5 * scale + 2.0**-40)

        # the per-tile scale is as tight as the power-of-two grid allows
        offsets = original - ts.tile_center[:, :, None]
        maxabs = np.abs(offsets).max(axis=(1, 2))
        occupied = maxabs > 0
        assert np.all(
            scale[occupied, 0, 0] * 2**29 <= np.maximum(maxabs[occupied], 2.0**-50)
        )

    def test_wide_binning_int16_zbin_lane(self, rng):
        """Beyond 128 redshift bins the int8 bin lane cannot hold the
        indices, so the payload switches to a (still lossless) int16
        lane via the numpy encoding path — the device decode must
        round-trip the wide bin indices bit-exactly."""
        from yet_another_wizz_tpu.ops.tiles import decode_fixedpoint_lanes

        num_bins = 200
        xyz, w, _ = random_cap_catalog(rng, 2000, 3)
        z = rng.integers(0, num_bins, len(xyz))
        patches = simple_patches(xyz, 5, rng)
        ts = build_tile_set(
            xyz, patches, 5, weights=w, zbins=z, num_bins=num_bins,
            tile_size=64,
        )
        assert ts.num_bins == num_bins
        host = ts.host_lanes()
        assert host.zbins.dtype == np.int16
        assert host.zbins.max() > 127  # the indices genuinely need int16
        decoded = np.asarray(
            decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
        )
        assert np.array_equal(decoded[:, 6, :], ts.lane_data[:, 6, :])
        assert np.array_equal(decoded[:, 7, :], ts.lane_data[:, 7, :])

    def test_uniform_weight_lane_elision(self, rng):
        """Unit-weight catalogs drop the weight channel from the link
        payload (17 -> 13 B/point): the host payload self-describes as
        3 packed channels + 9 decode parameters, and the device decode
        reconstructs the weight lane bit-exactly from the per-tile point
        count. Per-point weights keep the full 4-channel payload."""
        from yet_another_wizz_tpu.ops.tiles import (
            decode_fixedpoint_lanes,
            uniform_weight_fill,
        )

        xyz, w, z = random_cap_catalog(rng, 1500, 3)
        patches = simple_patches(xyz, 4, rng)

        for w0 in (1.0, 2.5):
            ts = build_tile_set(
                xyz, patches, 4, weights=np.full(len(xyz), w0),
                zbins=z, num_bins=3, tile_size=64,
            )
            host = ts.host_lanes()
            assert host.data.shape[1] == 3
            assert host.params.shape[1] == 9
            decoded = np.asarray(
                decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
            )
            assert np.array_equal(decoded[:, 6, :], ts.lane_data[:, 6, :])
            assert np.array_equal(decoded[:, 7, :], ts.lane_data[:, 7, :])

        # per-point weights: detection declines, the full payload crosses
        ts = build_tile_set(
            xyz, patches, 4, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        assert uniform_weight_fill(ts.lane_data) is None
        host = ts.host_lanes()
        assert host.data.shape[1] == 4
        assert host.params.shape[1] == 8
        decoded = np.asarray(
            decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
        )
        assert np.array_equal(decoded[:, 6, :], ts.lane_data[:, 6, :])

        # a zero weight INSIDE a tile's front run (a real point the user
        # weighted to zero) breaks the padding contract — detection must
        # decline rather than misread the hole as the tile's fill level
        ts = build_tile_set(
            xyz, patches, 4, weights=np.ones(len(xyz)), zbins=z,
            num_bins=3, tile_size=64,
        )
        full = np.flatnonzero(
            np.all(ts.lane_data[:, 6, :] != 0.0, axis=1)
        )
        assert len(full) > 0  # tile_size 64 over 1500 points: full tiles
        lane_hole = ts.lane_data.copy()
        lane_hole[full[0], 6, 3] = 0.0
        assert uniform_weight_fill(lane_hole) is None

    def test_zero_zbin_lane_elision(self, rng):
        """Unbinned catalogs (randoms, the unknown sample) hold an
        identically-zero bin lane: it is elided from the link payload
        (zero-width zbins array) and the device decode reconstructs the
        zero lane exactly. Binned catalogs keep the full lane."""
        from yet_another_wizz_tpu.ops.tiles import decode_fixedpoint_lanes

        xyz, w, z = random_cap_catalog(rng, 1500, 3)
        patches = simple_patches(xyz, 4, rng)

        # unbinned + per-point weights: only the bin lane is elided
        ts = build_tile_set(xyz, patches, 4, weights=w, tile_size=64)
        host = ts.host_lanes()
        assert host.zbins.shape == (ts.num_tiles, 0)
        assert host.data.shape[1] == 4  # weight lane still crosses
        decoded = np.asarray(
            decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
        )
        assert np.array_equal(decoded[:, 6, :], ts.lane_data[:, 6, :])
        assert np.array_equal(
            decoded[:, 7, :], np.zeros_like(ts.lane_data[:, 7, :])
        )

        # unbinned + unit weights (randoms): both elisions compose,
        # 12 B/point, and the tile-axis padding keeps the empty lane
        ts = build_tile_set(
            xyz, patches, 4, weights=np.ones(len(xyz)), tile_size=64
        )
        host = ts.host_lanes(padded_tiles=ts.num_tiles + 7)
        assert host.data.shape == (ts.num_tiles + 7, 3, 64)
        assert host.zbins.shape == (ts.num_tiles + 7, 0)
        decoded = np.asarray(
            decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
        )
        assert np.array_equal(
            decoded[: ts.num_tiles, 6, :], ts.lane_data[:, 6, :]
        )
        assert not decoded[:, 7, :].any()

        # a genuinely binned catalog keeps its lane
        ts = build_tile_set(
            xyz, patches, 4, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        host = ts.host_lanes()
        assert host.zbins.shape == (ts.num_tiles, 64)

        # a binned catalog whose points all happen to land in bin 0
        # (e.g. one block of a larger binned catalog) must ship the SAME
        # lane shape as sibling blocks — the elision is gated on the
        # declared bin count, not the lane contents, so the shared
        # decode program never recompiles per block
        ts = build_tile_set(
            xyz, patches, 4, weights=w,
            zbins=np.zeros(len(xyz), dtype=np.int64), num_bins=3,
            tile_size=64,
        )
        host = ts.host_lanes()
        assert host.zbins.shape == (ts.num_tiles, 64)

    def test_tile_caps_contain_points(self, rng):
        xyz, w, z = random_cap_catalog(rng, 1000, 2)
        patches = simple_patches(xyz, 3, rng)
        ts = build_tile_set(
            xyz, patches, 3, weights=w, zbins=z, num_bins=2, tile_size=64
        )
        data = ts.lane_data
        for t in range(ts.num_tiles):
            hi = data[t, 0:3, :].astype(np.float64).T
            lo = data[t, 3:6, :].astype(np.float64).T
            pts = hi + lo
            chord = np.linalg.norm(pts - ts.tile_center[t], axis=1)
            angle = 2 * np.arcsin(np.clip(chord / 2, 0, 1))
            assert np.all(angle <= ts.tile_radius[t] + 1e-7)


class TestEngineVsOracle:
    # Slot-level tolerances allow for single pair-weight flips where a pair
    # sits within float32 resolution (~1.4e-7 relative) of a bin boundary;
    # aggregated totals must hold the 1e-6 relative target.

    def _check(self, result, expect):
        assert_allclose(result, expect, rtol=1e-5, atol=10.0)
        assert_allclose(
            result.sum(axis=0), expect.sum(axis=0), rtol=2e-6, atol=1e-7
        )

    def test_cross_unbinned_cols(self, rng):
        result, expect = run_engine_vs_oracle(rng)
        self._check(result, expect)

    def test_cross_binned_cols(self, rng):
        result, expect = run_engine_vs_oracle(rng, cols_binned=True)
        self._check(result, expect)

    def test_auto_pairs(self, rng):
        result, expect = run_engine_vs_oracle(rng, auto=True)
        self._check(result, expect)

    def test_unweighted_integer_counts(self, rng):
        xyz1, _, z1 = random_cap_catalog(rng, 800, 2, weighted=False)
        xyz2, _, _ = random_cap_catalog(rng, 900, 2, weighted=False)
        patch1 = simple_patches(xyz1, 3, np.random.default_rng(7))
        patch2 = simple_patches(xyz2, 3, np.random.default_rng(7))
        ts1 = build_tile_set(
            xyz1, patch1, 3, zbins=z1, num_bins=2, tile_size=64
        )
        ts2 = build_tile_set(xyz2, patch2, 3, tile_size=64)

        edges = np.deg2rad(np.tile((0.3, 2.0), (2, 1)))
        chord2 = (2 * np.sin(edges / 2)) ** 2
        centers, radii = patch_geometry(xyz1, patch1, 3)
        linkage = build_linkage(centers, radii, edges.max() * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        result = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
        # unweighted counts are integers and must be reproduced exactly
        assert_allclose(result, np.round(result), atol=1e-9)
        expect = count_pairs_oracle(
            xyz1, np.ones(800), z1, patch1,
            xyz2, np.ones(900), None, patch2,
            pairs.slot_patches, edges,
        )
        assert_allclose(result, expect, atol=2.0)
        assert_allclose(result.sum(axis=0), expect.sum(axis=0), rtol=2e-6)

    def test_padded_slots_contract(self, rng):
        """``padded_slots=True`` keeps the engine's bucketed slot axis for
        jitted consumers: valid rows match the sliced result and the mode
        is refused outside single-device deferred execution."""
        import pytest

        from yet_another_wizz_tpu.ops.tiles import bucket_size

        xyz1, w1, z1 = random_cap_catalog(rng, 700, 2)
        xyz2, w2, _ = random_cap_catalog(rng, 800, 2)
        patch1 = simple_patches(xyz1, 3, np.random.default_rng(5))
        patch2 = simple_patches(xyz2, 3, np.random.default_rng(5))
        ts1 = build_tile_set(
            xyz1, patch1, 3, weights=w1, zbins=z1, num_bins=2, tile_size=64
        )
        ts2 = build_tile_set(xyz2, patch2, 3, weights=w2, tile_size=64)
        edges = np.deg2rad(np.tile((0.3, 2.0), (2, 1)))
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        centers, radii = patch_geometry(xyz1, patch1, 3)
        linkage = build_linkage(centers, radii, edges.max() * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)

        base = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
        padded = np.asarray(
            count_pairs_tiles(
                ts1, ts2, pairs, chord2, backend="xla", defer=True,
                padded_slots=True,
            )
        )
        assert padded.shape[0] == bucket_size(pairs.num_slots + 1, base=64)
        assert_allclose(
            padded[: pairs.num_slots].astype(np.float64), base,
            rtol=1e-6, atol=1e-3,
        )

        # refused without deferred execution, and with the audit/oracle
        # paths (both return repaired HOST counts)
        with pytest.raises(ValueError, match="padded_slots"):
            count_pairs_tiles(
                ts1, ts2, pairs, chord2, backend="xla", padded_slots=True
            )
        with pytest.raises(ValueError, match="padded_slots"):
            count_pairs_tiles(
                ts1, ts2, pairs, chord2, backend="xla", defer=True,
                padded_slots=True, audit=True, edges_radian=edges,
            )

    def test_small_angles_precision(self, rng):
        """Separations around 1e-4 rad: far below float32 resolution of the
        dot-product formulation; the hi/lo path must stay accurate."""
        n = 2000
        # points in a tiny cap (0.02 deg) so typical separations ~1e-4 rad
        xyz, w, z = random_cap_catalog(rng, n, 1, cap_deg=0.02)
        patches = np.zeros(n, dtype=int)
        ts = build_tile_set(
            xyz, patches, 1, weights=w, zbins=z, num_bins=1, tile_size=64
        )
        edges = np.array([[0.5e-4, 2e-4, 3e-4]])
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        centers, radii = patch_geometry(xyz, patches, 1)
        linkage = build_linkage(centers, radii, float(edges.max()) * 1.01)
        pairs = build_tile_pairs(ts, ts, linkage, auto=True)
        result = count_pairs_tiles(ts, ts, pairs, chord2, backend="xla")
        expect = count_pairs_oracle(
            xyz, w, z, patches, xyz, w, z, patches, pairs.slot_patches, edges
        )
        assert expect.sum() > 0
        assert_allclose(result, expect, rtol=1e-4, atol=10.0)
        assert_allclose(result.sum(axis=0), expect.sum(axis=0), rtol=3e-6)


class TestGreatCircleAnalytic:
    """Points every degree along the equator: pair counts against an
    angular bin have exactly known values (reference test strategy,
    /root/reference/tests/catalog/test_trees.py:134-254)."""

    def setup_method(self):
        deg = np.deg2rad(np.arange(360.0))
        self.xyz = radec_to_xyz(deg, np.zeros(360))
        self.n = 360

    def _count(self, lo_deg, hi_deg, weights=None):
        w = np.ones(self.n) if weights is None else weights
        ts = build_tile_set(
            self.xyz, np.zeros(self.n, dtype=int), 1,
            weights=w, zbins=np.zeros(self.n, dtype=int), num_bins=1,
            tile_size=64,
        )
        edges = np.deg2rad([[lo_deg, hi_deg]])
        chord2 = (2 * np.sin(edges / 2)) ** 2
        from yet_another_wizz_tpu.ops.linkage import Linkage

        linkage = Linkage(max_angle=np.pi, linked=np.ones((1, 1), bool))
        pairs = build_tile_pairs(ts, ts, linkage, auto=True)
        cum = count_pairs_tiles(ts, ts, pairs, chord2, backend="xla")
        return cum[0, 0, 1] - cum[0, 0, 0]

    def test_neighbour_counts(self):
        # (0.5, 1.5] deg: each point has exactly 2 neighbours at 1 deg
        assert self._count(0.5, 1.5) == pytest.approx(2 * self.n, rel=1e-6)

    def test_wider_window(self):
        # (0.5, 3.5] deg: neighbours at 1, 2, 3 deg on both sides
        assert self._count(0.5, 3.5) == pytest.approx(6 * self.n, rel=1e-6)

    def test_self_pairs_excluded(self):
        # (~0, 0.5] deg: no pairs below 1 deg separation, self pairs at 0
        # are excluded by the open lower edge
        assert self._count(1e-9, 0.5) == pytest.approx(0.0, abs=1e-6)

    def test_weighted(self):
        w = np.full(self.n, 2.0)
        assert self._count(0.5, 1.5, weights=w) == pytest.approx(
            2 * self.n * 4.0, rel=1e-6
        )

    def test_antipodal_window(self):
        # (178.5, 179.5] deg: exactly 2 neighbours at 179 deg separation
        assert self._count(178.5, 179.5) == pytest.approx(2 * self.n, rel=1e-6)


class TestThresholds:
    def test_validate_angle_range(self):
        limits = validate_angle_range([0.1], [0.2])
        assert limits.shape == (1, 2)
        with pytest.raises(ValueError):
            validate_angle_range([0.2], [0.1])
        with pytest.raises(ValueError):
            validate_angle_range([0.1], [4.0])
        with pytest.raises(ValueError):
            validate_angle_range([0.1, 0.2], [0.3])
        # NaN evaluates False in every comparison check and would
        # silently produce a zero-count measurement
        with pytest.raises(ValueError, match="finite"):
            validate_angle_range([np.nan], [0.2])
        with pytest.raises(ValueError, match="finite"):
            validate_angle_range([0.1], [np.inf])

    def test_unweighted_edges_are_exact(self):
        # without separation weighting the user's limits must pass
        # through exactly (no log10 roundtrip; ang_min=0 is valid and
        # must not emit warnings)
        import warnings

        from yet_another_wizz_tpu.ops.thresholds import _edges_for_limits

        limits = np.array([[0.0, 0.2], [0.1, 0.3]])
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            edges = _edges_for_limits(limits, None, 50)
        assert_allclose(edges, [0.0, 0.1, 0.2, 0.3], rtol=0, atol=0)

    def test_probe_size_must_cover_patches(self):
        from yet_another_wizz_tpu.ops.kmeans import kmeans_patch_centers

        xyz = radec_to_xyz(
            np.random.default_rng(0).uniform(0, 1, 300),
            np.random.default_rng(1).uniform(-0.5, 0.5, 300),
        )
        with pytest.raises(ValueError, match="probe_size"):
            kmeans_patch_centers(xyz, num_patches=64, probe_size=32)

    def test_weighted_rejects_zero_ang_min(self):
        # a zero lower limit feeds log10(0) into the weighted sub-edge
        # grid; without the explicit check every count becomes NaN
        scales = new_scales(0.0, 2.0, unit="rad")
        build_angular_edges(scales, np.array([0.4]))  # unweighted: fine
        with pytest.raises(ValueError, match="strictly positive"):
            build_angular_edges(
                scales, np.array([0.4]), weight_scale=-1.0
            )

    def test_single_scale_edges(self):
        scales = new_scales(1.0, 2.0, unit="deg")
        ae = build_angular_edges(scales, np.array([0.3, 0.5]))
        assert ae.num_bins == 2
        assert ae.num_edges == 2
        assert ae.num_scales == 1
        assert_allclose(ae.edges[0], np.deg2rad([1.0, 2.0]))
        # counts_to_scales: diff of cumulative
        cum = np.array([[[1.0, 5.0]], [[2.0, 3.0]]]).reshape(1, 2, 2)
        scales_counts = ae.counts_to_scales(cum)
        assert scales_counts.shape == (1, 1, 2)
        assert_allclose(scales_counts[0, 0], [4.0, 1.0])

    def test_multi_scale_shared_edges(self):
        scales = new_scales([1.0, 2.0], [2.0, 4.0], unit="deg")
        ae = build_angular_edges(scales, np.array([0.4]))
        # edges 1, 2, 4 deg; scale 0 = interval 0, scale 1 = interval 1
        assert ae.num_edges == 3
        cum = np.array([[[0.0, 10.0, 25.0]]])
        out = ae.counts_to_scales(cum)
        assert_allclose(out[:, 0, 0], [10.0, 15.0])

    def test_rweight_normalisation(self):
        scales = new_scales(1.0, 10.0, unit="deg")
        ae = build_angular_edges(
            scales, np.array([0.4]), weight_scale=-1.0, weight_res=16
        )
        assert ae.num_edges == 17
        # uniform interval counts weighted by theta^-1, normalised: the
        # scale map columns sum to 1 by construction
        assert_allclose(ae.scale_maps[0].sum(), 1.0, rtol=1e-12)

    def test_rweight_flat_counts_invariant(self):
        # with equal counts in every log sub-bin, the normalised weighting
        # must reproduce the per-interval count as the scale total
        scales = new_scales(1.0, 10.0, unit="deg")
        weighted = build_angular_edges(
            scales, np.array([0.4]), weight_scale=-1.0, weight_res=8
        )
        assert weighted.num_edges == 9
        # cumulative linear in edge index -> 5 counts per sub-interval
        cum_w = np.arange(9.0)[None, None, :] * 5.0
        total_w = weighted.counts_to_scales(cum_w).sum()
        assert_allclose(total_w, 5.0, rtol=1e-12)


class TestBoundaryAudit:
    """Exact-boundary audit: engineered on-edge pairs are repaired to the
    float64 oracle classification."""

    def _measure(self, rng, nudge, audit):
        from yet_another_wizz_tpu.ops.paircount import audit_boundary_counts

        num_bins, num_patches, tile_size = 2, 4, 64
        edges_deg = np.array([0.2, 1.0])
        xyz1, w1, z1 = random_cap_catalog(rng, 400, num_bins)
        xyz2, w2, z2 = random_cap_catalog(rng, 600, num_bins)

        # an engineered heavy pair at angle nudge * upper edge: lands within
        # float32 resolution of the bin boundary for nudge ~ 1
        theta = np.deg2rad(edges_deg[1]) * nudge
        a = radec_to_xyz([1.0], [0.3])[0]
        t = np.cross(a, [0.0, 0.0, 1.0])
        t /= np.linalg.norm(t)
        b = np.cos(theta) * a + np.sin(theta) * t
        xyz1 = np.vstack([xyz1, a])
        xyz2 = np.vstack([xyz2, b])
        w1 = np.append(w1, 100.0)
        w2 = np.append(w2, 100.0)
        z1 = np.append(z1, 0)
        z2 = np.append(z2, 0)

        patch_rng = np.random.default_rng(3)
        patch1 = simple_patches(xyz1, num_patches, patch_rng)
        centers = xyz1[np.random.default_rng(3).choice(
            len(xyz1), num_patches, replace=False)]
        patch2 = np.argmax(xyz2 @ centers.T, axis=1)

        ts1 = build_tile_set(
            xyz1, patch1, num_patches, weights=w1, zbins=z1,
            num_bins=num_bins, tile_size=tile_size,
        )
        ts2 = build_tile_set(
            xyz2, patch2, num_patches, weights=w2, tile_size=tile_size,
        )
        edges = np.deg2rad(np.tile(edges_deg, (num_bins, 1)))
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        pcenters, pradii = patch_geometry(xyz1, patch1, num_patches)
        linkage = build_linkage(pcenters, pradii, edges.max() * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)

        result = count_pairs_tiles(
            ts1, ts2, pairs, chord2, backend="xla",
            edges_radian=edges, audit=audit,
        )
        expect = count_pairs_oracle(
            xyz1, w1, z1, patch1, xyz2, w2, None, patch2,
            pairs.slot_patches, edges,
        )
        _, num_flagged = audit_boundary_counts(
            ts1, ts2, pairs, result, chord2, edges
        )
        return result, expect, num_flagged

    @pytest.mark.parametrize(
        "nudge", [1.0, 1.0 + 1e-8, 1.0 + 5e-8, 1.0 - 5e-8]
    )
    def test_on_edge_pair_matches_oracle(self, rng, nudge):
        result, expect, num_flagged = self._measure(rng, nudge, audit=True)
        assert num_flagged >= 1
        # without audit the engineered pair (weight 1e4) may sit in the
        # wrong bin; audited counts must match float64 classification
        assert_allclose(result, expect, rtol=1e-5, atol=1e-2)

    def test_genuine_flip_repaired(self, rng):
        # nudge inside the (t32, t64) threshold gap: the float32 engine
        # provably classifies the heavy pair into the wrong side of the bin
        # edge (error = the full 1e4 pair weight) and the audit repairs it
        nudge = 1.0 + 1e-8
        raw, expect, _ = self._measure(
            np.random.default_rng(12345), nudge, audit=False
        )
        fixed, expect, num_flagged = self._measure(
            np.random.default_rng(12345), nudge, audit=True
        )
        assert np.abs(raw - expect).max() > 100.0  # whole pair misplaced
        assert num_flagged >= 1
        assert np.abs(fixed - expect).max() < 1e-3

    def test_far_from_edges_passes_through(self, rng):
        result, expect, num_flagged = self._measure(rng, 0.5, audit=True)
        assert_allclose(result, expect, rtol=1e-4, atol=0.5)

    def test_audit_requires_edges(self, rng):
        with pytest.raises(ValueError, match="edges_radian"):
            count_pairs_tiles(
                None, None, None, np.zeros((1, 2), np.float32), audit=True
            )

    def test_gathered_flag_pass_matches_resident(self, rng, monkeypatch):
        """Tile sets beyond AUDIT_RESIDENT_BYTES stream host-gathered
        pair windows through the flag pass instead of uploading both
        full tile sets to one device; the repaired counts must be
        identical to the resident path."""
        from yet_another_wizz_tpu.ops import paircount as pc

        resident, expect, flagged_resident = self._measure(
            np.random.default_rng(777), 1.0 + 1e-8, audit=True
        )
        monkeypatch.setattr(pc, "AUDIT_RESIDENT_BYTES", 1)
        gathered, _, flagged_gathered = self._measure(
            np.random.default_rng(777), 1.0 + 1e-8, audit=True
        )
        assert flagged_gathered == flagged_resident >= 1
        assert_allclose(gathered, resident, rtol=0, atol=0)
        assert_allclose(gathered, expect, rtol=1e-5, atol=1e-2)


class TestPerTileZPruning:
    """Per-tile redshift-bin cutoff pruning in build_tile_pairs: pruned
    tile pairs must contribute exactly zero, so counts are unchanged while
    the pair list shrinks for redshift-dependent scales."""

    def _setup(self, rng, *, cols_binned, num_bins=6):
        xyz1, w1, z1 = random_cap_catalog(rng, 4000, num_bins)
        xyz2, w2, z2 = random_cap_catalog(rng, 5000, num_bins)
        patch1 = simple_patches(xyz1, 5, np.random.default_rng(3))
        patch2 = simple_patches(xyz2, 5, np.random.default_rng(3))
        ts1 = build_tile_set(
            xyz1, patch1, 5, weights=w1, zbins=z1, num_bins=num_bins,
            tile_size=64, layout="zmajor",
        )
        ts2 = build_tile_set(
            xyz2, patch2, 5, weights=w2,
            zbins=z2 if cols_binned else None,
            num_bins=num_bins if cols_binned else 0,
            tile_size=64, layout="zmajor" if cols_binned else "spatial",
        )
        # physical-scale-like edges: theta shrinks with the bin index
        theta_max = np.deg2rad(2.0) / (1.0 + np.arange(num_bins))
        edges = np.column_stack([0.1 * theta_max, theta_max])
        centers, radii = patch_geometry(xyz1, patch1, 5)
        linkage = build_linkage(centers, radii, edges.max() * 1.000001)
        raw = (xyz1, w1, z1, patch1, xyz2, w2, z2, patch2)
        return ts1, ts2, linkage, edges, raw

    def test_trailing_empty_patch_keeps_last_bin(self):
        """Regression: a trailing EMPTY patch used to clip the reduceat
        index of its (empty) tile into range, truncating the previous
        tile's segment and dropping its last point's bin — the maximum bin
        under the zmajor sort, silently undercounting high-z pairs."""
        xyz = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
        ts = build_tile_set(
            xyz, np.array([0, 0, 0], np.int16), 2,
            zbins=np.array([0, 0, 5]), num_bins=6, layout="zmajor",
        )
        assert ts.tile_zmax[0] == 5  # was 0 before the fix
        assert ts.tile_zmax[-1] == -1  # empty patch tile never links

    def test_tile_zranges_cover_points(self, rng):
        ts1, _, _, _, _ = self._setup(rng, cols_binned=False)
        zlane = ts1.lane_data[:, 7, :]
        wlane = ts1.lane_data[:, 6, :]
        for t in range(ts1.num_tiles):
            zs = zlane[t][wlane[t] > 0].astype(int)
            if len(zs):
                assert zs.min() >= ts1.tile_zmin[t]
                assert zs.max() <= ts1.tile_zmax[t]
                # z-major sort keeps tiles bin-coherent (narrow ranges)
                assert ts1.tile_zmax[t] - ts1.tile_zmin[t] <= 1 or (
                    np.all(np.diff(zs) >= 0)
                )

    @pytest.mark.parametrize("cols_binned", [False, True])
    def test_pruned_counts_identical(self, rng, cols_binned):
        ts1, ts2, linkage, edges, raw = self._setup(
            rng, cols_binned=cols_binned
        )
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        unpruned = build_tile_pairs(ts1, ts2, linkage, auto=False)
        pruned = build_tile_pairs(
            ts1, ts2, linkage, auto=False,
            bin_max_angles=edges.max(axis=1),
        )
        assert pruned.num_pairs < unpruned.num_pairs
        a = count_pairs_tiles(ts1, ts2, unpruned, chord2, backend="xla")
        b = count_pairs_tiles(ts1, ts2, pruned, chord2, backend="xla")
        # identical patch-pair slots, so the tensors compare directly
        np.testing.assert_array_equal(
            np.asarray(a, np.float64).sum(), np.asarray(b, np.float64).sum()
        )
        assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            rtol=1e-6, atol=1e-9,
        )

    def test_pruned_matches_float64_oracle(self, rng):
        ts1, ts2, linkage, edges, raw = self._setup(rng, cols_binned=True)
        xyz1, w1, z1, patch1, xyz2, w2, z2, patch2 = raw
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        pruned = build_tile_pairs(
            ts1, ts2, linkage, auto=False,
            bin_max_angles=edges.max(axis=1),
        )
        result = count_pairs_tiles(ts1, ts2, pruned, chord2, backend="xla")
        expect = count_pairs_oracle(
            xyz1, w1, z1, patch1, xyz2, w2, z2, patch2,
            pruned.slot_patches, edges,
        )
        assert_allclose(
            np.asarray(result, np.float64), expect, rtol=1e-5, atol=1e-6
        )

    def test_disjoint_bins_dropped_for_binned_cols(self, rng):
        ts1, ts2, linkage, edges, _ = self._setup(rng, cols_binned=True)
        pruned = build_tile_pairs(
            ts1, ts2, linkage, auto=False,
            bin_max_angles=edges.max(axis=1),
        )
        lo = np.maximum(
            ts1.tile_zmin[pruned.tile1], ts2.tile_zmin[pruned.tile2]
        )
        hi = np.minimum(
            ts1.tile_zmax[pruned.tile1], ts2.tile_zmax[pruned.tile2]
        )
        assert np.all(lo <= hi)


class TestLayoutChooser:
    """The measurement picks the zmajor tile layout only when the angular
    cutoff dominates the (inflated) tile cap radii."""

    def _catalog(self, rng, n=20_000):
        from yet_another_wizz_tpu.catalog import Catalog

        ra = rng.uniform(0.2, 0.6, n)
        dec = rng.uniform(-0.2, 0.2, n)
        z = rng.uniform(0.1, 1.0, n)
        return Catalog.from_arrays(ra, dec, redshifts=z, degrees=False,
                                   patch_num=8)

    def test_small_scales_stay_spatial(self, rng):
        from yet_another_wizz_tpu.correlation.measurements import (
            _preferred_tile_layout,
        )

        catalog = self._catalog(rng)
        scales = new_scales(0.01, 0.05, unit="deg")
        edges = build_angular_edges(scales, np.linspace(0.15, 0.95, 6))
        assert _preferred_tile_layout(
            catalog, 6, edges, equal_bin_counting=False
        ) == "spatial"
        # equal-bin counting always benefits from disjoint-bin drops
        assert _preferred_tile_layout(
            catalog, 6, edges, equal_bin_counting=True
        ) == "zmajor"

    def test_large_scales_go_zmajor(self, rng):
        from yet_another_wizz_tpu.correlation.measurements import (
            _preferred_tile_layout,
        )

        catalog = self._catalog(rng)
        scales = new_scales(1.0, 10.0, unit="deg")
        edges = build_angular_edges(scales, np.linspace(0.15, 0.95, 6))
        assert _preferred_tile_layout(
            catalog, 6, edges, equal_bin_counting=False
        ) == "zmajor"

    def test_unbinned_always_spatial(self, rng):
        from yet_another_wizz_tpu.correlation.measurements import (
            _preferred_tile_layout,
        )

        assert _preferred_tile_layout(
            None, 0, None, equal_bin_counting=False
        ) == "spatial"

    def test_measurement_identical_across_layouts(self, rng):
        """Same counts regardless of the layout the chooser picks."""
        from yet_another_wizz_tpu.catalog import Catalog
        from yet_another_wizz_tpu.config import Configuration
        from yet_another_wizz_tpu.correlation.measurements import (
            autocorrelate,
        )

        n = 6000
        ra = rng.uniform(0.2, 0.5, n)
        dec = rng.uniform(-0.15, 0.15, n)
        z = rng.uniform(0.15, 0.9, n)
        data = Catalog.from_arrays(ra, dec, redshifts=z, degrees=False,
                                   patch_num=6)
        rand = Catalog.from_arrays(
            rng.uniform(0.2, 0.5, 2 * n), rng.uniform(-0.15, 0.15, 2 * n),
            redshifts=rng.choice(z, 2 * n), degrees=False,
            patch_centers=data.get_centers(),
        )
        # large angular scales: the chooser goes zmajor for these catalogs
        config = Configuration.create(
            rmin=0.5, rmax=2.0, unit="deg", zmin=0.15, zmax=0.9, num_bins=4,
        )
        (w_large,) = autocorrelate(config, data, rand, backend="xla")
        oracle_large, = autocorrelate(config, data, rand, backend="oracle")
        assert_allclose(
            w_large.dd.counts.counts, oracle_large.dd.counts.counts,
            rtol=1e-5, atol=1e-6,
        )


    def test_build_trees_warms_measurement_layouts(self, rng):
        """`build_trees` pre-builds the tile sets a measurement will
        request (zmajor for equal-bin counting; with `max_angle` also the
        cross-correlation row layout) instead of a layout nothing uses."""
        from yet_another_wizz_tpu.binning import Binning
        from yet_another_wizz_tpu.ops.tiles import preferred_tile_layout

        catalog = self._catalog(rng, n=5000)
        binning = Binning(np.linspace(0.1, 1.0, 7))
        catalog.build_trees(binning.edges)
        layouts = {key[4] for key in catalog._tile_cache}
        assert "zmajor" in layouts

        # tiny angular scale: a cross measurement's row side goes spatial
        catalog.drop_tile_cache()
        max_angle = 1e-4
        assert preferred_tile_layout(
            catalog, 6, max_angle, equal_bin_counting=False
        ) == "spatial"
        catalog.build_trees(binning.edges, max_angle=max_angle)
        layouts = {key[4] for key in catalog._tile_cache}
        assert {"zmajor", "spatial"} <= layouts

    def test_num_candidate_pairs_matches_engine(self, rng):
        """The public work statistic equals the pruned pair list the
        engine processes (not the unpruned spatial pair grid)."""
        from yet_another_wizz_tpu.config import Configuration
        from yet_another_wizz_tpu.correlation.measurements import (
            PatchLinkage,
        )

        from yet_another_wizz_tpu.catalog import Catalog

        data = self._catalog(rng, n=8000)
        rng2 = np.random.default_rng(5)
        rand = Catalog.from_arrays(
            rng2.uniform(0.2, 0.6, 8000), rng2.uniform(-0.2, 0.2, 8000),
            redshifts=rng2.uniform(0.1, 1.0, 8000), degrees=False,
            patch_centers=data.get_centers(),
        )
        config = Configuration.create(
            rmin=0.5, rmax=2.0, unit="deg", zmin=0.1, zmax=1.0, num_bins=4,
        )
        links = PatchLinkage.from_catalogs(config, data, rand)
        num = links.num_candidate_pairs(data)  # auto: equal-bin counting
        tiles1, _, pairs = links._build_engine_inputs(
            data, data, auto=True, binned2=True, mode="nn"
        )
        assert num == pairs.num_pairs * tiles1.tile_size**2
        # cross against the unpruned grid: pruning may only shrink it
        cross = links.num_candidate_pairs(data, rand, binned2=False)
        ts1 = data.get_tiles(config.binning.binning)
        ts2 = rand.get_tiles(None)
        unpruned = build_tile_pairs(ts1, ts2, links.linkage, auto=False)
        assert cross <= unpruned.num_pairs * ts1.tile_size**2


class TestShapeBucketing:
    """Dynamic sizes are padded to a quarter-octave grid so engine
    programs are reused across catalogs/linkages (remote compiles cost
    minutes at survey scale)."""

    def test_bucket_size_grid(self):
        from yet_another_wizz_tpu.ops.tiles import bucket_size

        assert bucket_size(1) == 512
        assert bucket_size(512) == 512
        assert bucket_size(513) == 640
        assert bucket_size(5873) == 6144
        assert bucket_size(1024) == 1024
        for n in (3, 97, 1000, 4097, 123456):
            b = bucket_size(n)
            assert b >= n
            assert b <= max(512, int(1.25 * n) + 1)  # <= 25% waste

    def test_bucket_size_multiple_of(self):
        """Chunked callers need the bucketed size to stay reshapeable for
        chunk sizes that do not divide the quarter-octave grid points."""
        from yet_another_wizz_tpu.ops.tiles import bucket_size

        for chunk in (3, 8, 24, 48):
            for n in (1, 100, 390, 408, 5873):
                b = bucket_size(n, base=16 * chunk, multiple_of=chunk)
                assert b >= n and b % chunk == 0

    def test_device_data_padded_to_bucket(self, rng):
        from yet_another_wizz_tpu.ops.tiles import bucket_size

        xyz, w, z = random_cap_catalog(rng, 2000, 3)
        patches = simple_patches(xyz, 5, rng)
        ts = build_tile_set(
            xyz, patches, 5, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        dev = ts.device_data()
        assert dev.shape[0] == bucket_size(ts.num_tiles)
        # pad tiles carry zero weights
        assert float(dev[ts.num_tiles:, 6, :].sum()) == 0.0

    def test_xla_program_reused_across_slot_counts(self):
        """Measurements with different catalogs/pair counts in the same
        buckets must not trigger a fresh compile (trace-cache hit).

        Seeds are pinned to problems whose padded pair lists land in the
        SAME quarter-octave bucket (1536): nearby sizes straddling a
        bucket boundary legitimately compile separately, which is not
        what this test is about."""
        from yet_another_wizz_tpu.ops.paircount import _count_pairs_xla

        from yet_another_wizz_tpu.ops import paircount

        observed_shapes = []
        inner = paircount._count_pairs_xla

        class Spy:
            def __call__(self, *args, **kwargs):
                observed_shapes.append(args[2].shape)
                return inner(*args, **kwargs)

            def __getattr__(self, name):
                return getattr(inner, name)

        misses_before = inner._cache_size()
        paircount._count_pairs_xla = Spy()
        try:
            for seed, n2 in ((11, 4000), (12, 4100), (13, 4100)):
                result, expect = run_engine_vs_oracle(
                    np.random.default_rng(seed), n2=n2, num_patches=5
                )
                assert_allclose(result, expect, rtol=1e-4, atol=10.0)
        finally:
            paircount._count_pairs_xla = inner
        # precondition, not the property under test: all runs landed in
        # one bucket (otherwise separate compiles are correct behavior
        # and the seeds above need re-pinning)
        assert len(set(observed_shapes)) == 1, observed_shapes
        misses_after = inner._cache_size()
        assert misses_after - misses_before <= 1


class TestDirectCounting:
    """Direct separation-weighted counting (O(1) per-pair sub-bin weights,
    counting only at the scale-limit edges) must reproduce the union-edge
    cumulative histogram and the float64 oracle."""

    ZMIDS = np.array([0.3, 0.5, 0.8])

    def _scales(self):
        # overlapping multi-scale limits: the interior limits split
        # uniform sub-intervals, exercising the below/above adjustments
        return new_scales([0.05, 0.12, 0.3], [0.2, 0.5, 1.0], unit="deg")

    def _problem(self, rng, num_bins=3, num_patches=4):
        xyz1, w1, z1 = random_cap_catalog(rng, 2500, num_bins)
        xyz2, w2, _ = random_cap_catalog(rng, 3500, num_bins)
        patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
        patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
        ts1 = build_tile_set(
            xyz1, patch1, num_patches, weights=w1, zbins=z1,
            num_bins=num_bins, tile_size=64,
        )
        ts2 = build_tile_set(
            xyz2, patch2, num_patches, weights=w2, tile_size=64
        )
        centers, radii = patch_geometry(xyz1, patch1, num_patches)
        return ts1, ts2, centers, radii

    def _per_scale(self, ts1, ts2, pairs, edges, backend):
        if edges.direct is not None and backend != "oracle":
            cum = count_pairs_tiles(
                ts1, ts2, pairs, edges.direct.combined_table(),
                backend=backend, direct=edges.direct.spec,
                interpret=True,
            )
            return edges.direct.counts_to_scales(cum)
        cum = count_pairs_tiles(
            ts1, ts2, pairs, edges.chord2_table, backend=backend,
            edges_radian=edges.edges,
        )
        return edges.counts_to_scales(cum)

    def test_heuristic_builds_direct_tables(self):
        scales = self._scales()
        many = build_angular_edges(
            scales, self.ZMIDS, weight_scale=-1.0, weight_res=24
        )
        assert many.direct is not None  # auto: union edges >= crossover
        assert many.direct.num_sub == 24
        assert many.direct.num_below >= 1 and many.direct.num_above >= 1
        few = build_angular_edges(
            scales, self.ZMIDS, weight_scale=-1.0, weight_res=4
        )
        assert few.direct is None  # below the crossover
        plain = build_angular_edges(scales, self.ZMIDS)
        assert plain.direct is None  # no separation weighting
        forced = build_angular_edges(
            scales, self.ZMIDS, weight_scale=-1.0, weight_res=4,
            counting="direct",
        )
        assert forced.direct is not None
        with pytest.raises(ValueError, match="direct"):
            build_angular_edges(scales, self.ZMIDS, counting="direct")

    @pytest.mark.parametrize("alpha", [-1.0, 1.5])
    def test_direct_matches_cumulative_and_oracle(self, rng, alpha):
        ts1, ts2, centers, radii = self._problem(rng)
        scales = self._scales()
        direct = build_angular_edges(
            scales, self.ZMIDS, weight_scale=alpha, weight_res=24,
            counting="direct",
        )
        cumulative = build_angular_edges(
            scales, self.ZMIDS, weight_scale=alpha, weight_res=24,
            counting="cumulative",
        )
        assert direct.direct is not None and cumulative.direct is None

        linkage = build_linkage(centers, radii, direct.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)

        via_direct = self._per_scale(ts1, ts2, pairs, direct, "xla")
        via_cum = self._per_scale(ts1, ts2, pairs, cumulative, "xla")
        via_oracle = self._per_scale(ts1, ts2, pairs, cumulative, "oracle")
        assert_allclose(via_direct, via_cum, rtol=2e-5, atol=1e-7)
        assert_allclose(via_direct, via_oracle, rtol=2e-5, atol=1e-7)

    def test_direct_pallas_interpret_matches_xla(self, rng):
        ts1, ts2, centers, radii = self._problem(rng)
        edges = build_angular_edges(
            self._scales(), self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        linkage = build_linkage(centers, radii, edges.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        xla = self._per_scale(ts1, ts2, pairs, edges, "xla")
        pallas = self._per_scale(ts1, ts2, pairs, edges, "pallas")
        assert_allclose(pallas, xla, rtol=1e-5, atol=1e-7)

    def test_direct_refuses_audit_and_oracle(self, rng):
        ts1, ts2, centers, radii = self._problem(rng)
        edges = build_angular_edges(
            self._scales(), self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        linkage = build_linkage(centers, radii, edges.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        with pytest.raises(ValueError, match="direct"):
            count_pairs_tiles(
                ts1, ts2, pairs, edges.direct.combined_table(),
                backend="xla", direct=edges.direct.spec, audit=True,
                edges_radian=edges.direct.edges,
            )
        with pytest.raises(ValueError, match="direct"):
            count_pairs_tiles(
                ts1, ts2, pairs, edges.direct.combined_table(),
                backend="oracle", direct=edges.direct.spec,
                edges_radian=edges.direct.edges,
            )

    def test_measurement_rweight_direct_matches_oracle(self, rng):
        """Full measurement with rweight at resolution 32: the auto
        heuristic engages direct counting and the result matches the
        oracle backend (union-edge float64 path)."""
        from yet_another_wizz_tpu import Catalog, Configuration
        from yet_another_wizz_tpu.correlation.measurements import (
            PatchLinkage, crosscorrelate,
        )
        from yet_another_wizz_tpu.examples import generate_mock_data

        mock = generate_mock_data(1200, 1800, 3000, seed=5)
        ref = Catalog.from_arrays(
            **mock["reference"], degrees=False, patch_num=4
        )
        unk = Catalog.from_arrays(
            **mock["unknown"], degrees=False, patch_centers=ref.get_centers()
        )
        rand = Catalog.from_arrays(
            **mock["randoms"], degrees=False, patch_centers=ref.get_centers()
        )
        config = Configuration.create(
            rmin=[300, 500, 1000], rmax=[1000, 3000, 5000], unit="kpc",
            zmin=0.15, zmax=1.0, num_bins=3, rweight=-1.0, resolution=32,
        )
        links = PatchLinkage.from_catalogs(config, ref, unk, rand)
        assert links.edges.direct is not None  # heuristic engaged

        xla = crosscorrelate(
            config, ref, unk, ref_rand=rand, backend="xla"
        )
        oracle = crosscorrelate(
            config, ref, unk, ref_rand=rand, backend="oracle"
        )
        for corr_x, corr_o in zip(xla, oracle):
            assert_allclose(
                corr_x.dd.counts.counts, corr_o.dd.counts.counts,
                rtol=5e-5, atol=1e-7,
            )
            assert_allclose(
                corr_x.sample().data, corr_o.sample().data, rtol=1e-4
            )

    def test_small_angle_gate(self):
        """``DirectEdges.spec`` selects the sqrt/arcsine-free index path
        exactly when every counting edge fits the fitted polynomial range
        (gweight.THETA_POLY_MAX)."""
        from yet_another_wizz_tpu.ops.gweight import THETA_POLY_MAX

        narrow = build_angular_edges(
            self._scales(), self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        assert float(np.max(narrow.direct.edges)) <= THETA_POLY_MAX
        assert narrow.direct.spec[3] is True

        wide = build_angular_edges(
            new_scales([0.05], [1.4], unit="rad"), self.ZMIDS,
            weight_scale=-1.0, weight_res=24, counting="direct",
        )
        assert float(np.max(wide.direct.edges)) > THETA_POLY_MAX
        assert wide.direct.spec[3] is False

    def test_small_angle_path_matches_arcsine_path(self, rng):
        """The polynomial log10(theta) evaluation must agree with the
        explicit sqrt -> arcsine -> log chain: identical static config
        except the flag, per-scale counts equal to float32 boundary
        noise."""
        ts1, ts2, centers, radii = self._problem(rng)
        edges = build_angular_edges(
            self._scales(), self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        assert edges.direct.spec[3] is True
        linkage = build_linkage(centers, radii, edges.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        table = edges.direct.combined_table()
        base = edges.direct.spec[:3]
        poly = count_pairs_tiles(
            ts1, ts2, pairs, table, backend="xla", direct=base + (True,),
        )
        arcsine = count_pairs_tiles(
            ts1, ts2, pairs, table, backend="xla", direct=base + (False,),
        )
        assert_allclose(
            edges.direct.counts_to_scales(poly),
            edges.direct.counts_to_scales(arcsine),
            rtol=2e-5, atol=1e-7,
        )

    def test_wide_angle_grid_matches_cumulative(self, rng):
        """A grid wider than the polynomial's fitted range falls back to
        the arcsine path and still reproduces the union-edge cumulative
        histogram."""
        ts1, ts2, centers, radii = self._problem(rng)
        scales = new_scales([0.05, 0.4], [0.5, 1.35], unit="rad")
        direct = build_angular_edges(
            scales, self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        assert direct.direct.spec[3] is False
        cumulative = build_angular_edges(
            scales, self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="cumulative",
        )
        linkage = build_linkage(centers, radii, direct.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        via_direct = self._per_scale(ts1, ts2, pairs, direct, "xla")
        via_cum = self._per_scale(ts1, ts2, pairs, cumulative, "xla")
        # float32 sub-bin boundary wobble grows with the angle
        # (d(theta)/d(chord2) diverges towards pi), so the agreement band
        # is wider than the small-angle tests' 2e-5 — this is a property
        # of the arcsine formulation at wide angles, independent of the
        # small-angle polynomial (disabled here)
        assert_allclose(via_direct, via_cum, rtol=5e-4, atol=1e-7)

    @pytest.mark.parametrize("data_sharding", ["replicated", "columns", "ring"])
    def test_direct_sharded_matches_single_device(self, rng, data_sharding):
        """Direct counting composes with the device mesh (all layouts)."""
        from yet_another_wizz_tpu.parallel import (
            count_pairs_sharded, default_mesh,
        )

        ts1, ts2, centers, radii = self._problem(rng)
        edges = build_angular_edges(
            self._scales(), self.ZMIDS, weight_scale=-1.0, weight_res=24,
            counting="direct",
        )
        linkage = build_linkage(centers, radii, edges.max_angle * 1.000001)
        pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
        single = count_pairs_tiles(
            ts1, ts2, pairs, edges.direct.combined_table(),
            backend="xla", direct=edges.direct.spec,
        )
        sharded = count_pairs_sharded(
            ts1, ts2, pairs, edges.direct.combined_table(),
            mesh=default_mesh(4), data_sharding=data_sharding,
            direct=edges.direct.spec,
        )
        assert_allclose(sharded, single, rtol=1e-5, atol=1e-4)


def test_tile_pair_enumeration_chunked_identical(rng, monkeypatch):
    """The bounded-memory candidate grouping (MAX_CANDIDATE_CHUNK) must
    reproduce the single-pass enumeration exactly, including oversize
    single slots and the slot-sorted row-major order."""
    import yet_another_wizz_tpu.ops.linkage as linkage_mod

    # the second call repeats the first call's inputs: without this the
    # pair-list memo would return the first result and the comparison
    # would be vacuous
    monkeypatch.setenv("YAWT_PAIR_MEMO", "0")

    xyz1, w1, z1 = random_cap_catalog(rng, 3000, 3)
    xyz2, w2, _ = random_cap_catalog(rng, 4000, 3)
    p1 = simple_patches(xyz1, 6, np.random.default_rng(3))
    p2 = simple_patches(xyz2, 6, np.random.default_rng(3))
    ts1 = build_tile_set(
        xyz1, p1, 6, weights=w1, zbins=z1, num_bins=3, tile_size=64
    )
    ts2 = build_tile_set(xyz2, p2, 6, weights=w2, tile_size=64)
    centers, radii = patch_geometry(xyz1, p1, 6)
    linkage = build_linkage(centers, radii, 0.02)
    angles = np.array([0.015, 0.018, 0.02])

    from yet_another_wizz_tpu import _native

    monkeypatch.setattr(_native, "NATIVE_ENABLED", False)
    base = build_tile_pairs(ts1, ts2, linkage, auto=False, bin_max_angles=angles)
    monkeypatch.setattr(linkage_mod, "MAX_CANDIDATE_CHUNK", 7)
    tiny = linkage_mod.build_tile_pairs(
        ts1, ts2, linkage, auto=False, bin_max_angles=angles
    )
    np.testing.assert_array_equal(tiny.tile1, base.tile1)
    np.testing.assert_array_equal(tiny.tile2, base.tile2)
    np.testing.assert_array_equal(tiny.slot, base.slot)


def test_tile_pair_filter_native_equals_numpy(rng, monkeypatch):
    """The native streaming tile-pair filter reproduces the numpy group
    pass EXACTLY (same kept set, same slot-sorted row-major order) in all
    three cutoff modes: global angle, row-binned, and both-binned."""
    from yet_another_wizz_tpu import _native

    if not _native.NATIVE_ENABLED:
        pytest.skip("native library unavailable")
    import yet_another_wizz_tpu.ops.linkage as linkage_mod

    # the fallback call repeats the native call's inputs: without this the
    # pair-list memo would return the native result and the comparison
    # would be vacuous
    monkeypatch.setenv("YAWT_PAIR_MEMO", "0")

    xyz1, w1, z1 = random_cap_catalog(rng, 3000, 3)
    xyz2, w2, z2 = random_cap_catalog(rng, 4000, 3)
    p1 = simple_patches(xyz1, 6, np.random.default_rng(3))
    p2 = simple_patches(xyz2, 6, np.random.default_rng(3))
    binned1 = build_tile_set(
        xyz1, p1, 6, weights=w1, zbins=z1, num_bins=3, tile_size=64
    )
    binned2 = build_tile_set(
        xyz2, p2, 6, weights=w2, zbins=z2, num_bins=3, tile_size=64
    )
    spatial2 = build_tile_set(xyz2, p2, 6, weights=w2, tile_size=64)
    centers, radii = patch_geometry(xyz1, p1, 6)
    linkage = build_linkage(centers, radii, 0.02)
    angles = np.array([0.015, 0.018, 0.02])

    cases = [
        dict(tiles2=spatial2, bin_max_angles=None),      # global cutoff
        dict(tiles2=spatial2, bin_max_angles=angles),    # row-binned
        dict(tiles2=binned2, bin_max_angles=angles),     # both-binned
    ]
    for case in cases:
        native = build_tile_pairs(
            binned1, case["tiles2"], linkage, auto=False,
            bin_max_angles=case["bin_max_angles"],
        )
        monkeypatch.setattr(_native, "NATIVE_ENABLED", False)
        fallback = linkage_mod.build_tile_pairs(
            binned1, case["tiles2"], linkage, auto=False,
            bin_max_angles=case["bin_max_angles"],
        )
        monkeypatch.setattr(_native, "NATIVE_ENABLED", True)
        assert len(native.tile1) > 0
        np.testing.assert_array_equal(native.tile1, fallback.tile1)
        np.testing.assert_array_equal(native.tile2, fallback.tile2)
        np.testing.assert_array_equal(native.slot, fallback.slot)


class TestPairListMemo:
    """The pruned tile-pair list is memoised per row tile set
    (ops/linkage.py): identical inputs return the SAME TilePairs object
    (so the engines reuse its device-resident index upload), any changed
    input misses, the LRU stays bounded, and entries die with their
    column tile set."""

    def _inputs(self, rng, num_patches=4):
        xyz, w, z = random_cap_catalog(rng, 2000, 3)
        patch = simple_patches(xyz, num_patches, np.random.default_rng(3))
        ts = build_tile_set(
            xyz, patch, num_patches, weights=w, zbins=z, num_bins=3,
            tile_size=64,
        )
        centers, radii = patch_geometry(xyz, patch, num_patches)
        linkage = build_linkage(centers, radii, 0.02)
        return ts, linkage

    def test_hit_and_key_sensitivity(self, rng):
        ts, linkage = self._inputs(rng)
        angles = np.array([0.015, 0.018, 0.02])
        first = build_tile_pairs(ts, ts, linkage, auto=True, bin_max_angles=angles)
        again = build_tile_pairs(ts, ts, linkage, auto=True, bin_max_angles=angles)
        assert again is first
        # every key ingredient produces a miss when changed
        other_auto = build_tile_pairs(
            ts, ts, linkage, auto=False, bin_max_angles=angles
        )
        assert other_auto is not first
        other_angles = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles * 0.9
        )
        assert other_angles is not first
        wider = type(linkage)(
            max_angle=linkage.max_angle * 1.5, linked=linkage.linked
        )
        assert (
            build_tile_pairs(ts, ts, wider, auto=True, bin_max_angles=angles)
            is not first
        )

    def test_disabled_by_env(self, rng, monkeypatch):
        ts, linkage = self._inputs(rng)
        angles = np.array([0.015, 0.018, 0.02])
        monkeypatch.setenv("YAWT_PAIR_MEMO", "0")
        a = build_tile_pairs(ts, ts, linkage, auto=True, bin_max_angles=angles)
        b = build_tile_pairs(ts, ts, linkage, auto=True, bin_max_angles=angles)
        assert a is not b
        np.testing.assert_array_equal(a.tile1, b.tile1)
        np.testing.assert_array_equal(a.slot, b.slot)

    def test_memoised_equals_fresh(self, rng, monkeypatch):
        ts, linkage = self._inputs(rng)
        angles = np.array([0.015, 0.018, 0.02])
        memoised = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles
        )
        memoised_again = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles
        )
        assert memoised_again is memoised
        monkeypatch.setenv("YAWT_PAIR_MEMO", "0")
        fresh = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles
        )
        np.testing.assert_array_equal(memoised.tile1, fresh.tile1)
        np.testing.assert_array_equal(memoised.tile2, fresh.tile2)
        np.testing.assert_array_equal(memoised.slot, fresh.slot)
        np.testing.assert_array_equal(
            memoised.slot_patches, fresh.slot_patches
        )

    def test_lru_bound(self, rng):
        from yet_another_wizz_tpu.ops.linkage import _PAIR_MEMO_SIZE

        ts, linkage = self._inputs(rng)
        for i in range(_PAIR_MEMO_SIZE + 4):
            build_tile_pairs(
                ts, ts, linkage, auto=True,
                bin_max_angles=np.full(3, 0.01 + i * 1e-4),
            )
        assert len(ts._pair_memo) <= _PAIR_MEMO_SIZE

    def test_entry_dies_with_column_tiles(self, rng):
        import gc

        ts, linkage = self._inputs(rng)
        xyz, w, _ = random_cap_catalog(np.random.default_rng(7), 1500, 1)
        patch = simple_patches(xyz, 4, np.random.default_rng(3))
        col = build_tile_set(xyz, patch, 4, weights=w, tile_size=64)
        build_tile_pairs(ts, col, linkage, auto=False)
        with_col = len(ts._pair_memo)
        del col
        gc.collect()
        assert len(ts._pair_memo) < with_col

    def test_engine_reuses_index_upload(self, rng):
        """Two identical engine calls share one TilePairs object and its
        cached stacked index upload; the counts are identical."""
        ts, linkage = self._inputs(rng)
        angles = np.array([0.015, 0.018, 0.02])
        edges = np.tile([0.002, 0.02], (3, 1))
        chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
        pairs = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles
        )
        first = count_pairs_tiles(
            ts, ts, pairs, chord2, backend="pallas", mesh="single",
            interpret=True,
        )
        cached = dict(pairs._device_cache)
        assert any(k[0] == "stacked" for k in cached if isinstance(k, tuple))
        pairs_again = build_tile_pairs(
            ts, ts, linkage, auto=True, bin_max_angles=angles
        )
        assert pairs_again is pairs
        second = count_pairs_tiles(
            ts, ts, pairs_again, chord2, backend="pallas", mesh="single",
            interpret=True,
        )
        for key, value in cached.items():
            assert pairs._device_cache[key] is value
        np.testing.assert_array_equal(first, second)


class TestFusedLaneUpload:
    """The fused single-buffer upload (one uint8 transfer per block,
    ops/tiles.py:fuse_host_lanes + _decode_fused_fn) must decode
    BIT-IDENTICALLY to the split three-array path, for every payload
    variant the host encoder produces."""

    def _assert_fused_matches_split(self, ts, padded_tiles=None):
        from yet_another_wizz_tpu.ops.tiles import (
            _decode_fused_fn,
            decode_fixedpoint_lanes,
            fuse_host_lanes,
        )

        host = ts.host_lanes(padded_tiles)
        assert host.encoding == "fixedpoint"
        split = np.asarray(
            decode_fixedpoint_lanes()(host.data, host.params, host.zbins)
        )
        zbin_itemsize = (
            0
            if host.zbins is None or host.zbins.shape[-1] == 0
            else host.zbins.dtype.itemsize
        )
        fused = np.asarray(
            _decode_fused_fn(
                host.data.shape[0],
                host.data.shape[1],
                host.data.shape[2],
                host.params.shape[1],
                zbin_itemsize,
            )(fuse_host_lanes(host))
        )
        assert fused.dtype == split.dtype and fused.shape == split.shape
        # bit-exact: compare the raw float32 bit patterns
        assert np.array_equal(
            fused.view(np.uint32), split.view(np.uint32)
        )
        return host

    def test_per_point_weights_int8_bins(self, rng):
        xyz, w, z = random_cap_catalog(rng, 2000, 3)
        patches = simple_patches(xyz, 5, rng)
        ts = build_tile_set(
            xyz, patches, 5, weights=w, zbins=z, num_bins=3, tile_size=64
        )
        host = self._assert_fused_matches_split(ts)
        assert host.data.shape[1] == 4 and host.zbins.dtype == np.int8

    def test_uniform_weight_elision(self, rng):
        xyz, _, z = random_cap_catalog(rng, 1500, 3)
        patches = simple_patches(xyz, 4, rng)
        ts = build_tile_set(
            xyz, patches, 4, weights=np.full(len(xyz), 2.5),
            zbins=z, num_bins=3, tile_size=64,
        )
        host = self._assert_fused_matches_split(ts)
        assert host.data.shape[1] == 3 and host.params.shape[1] == 9

    def test_unbinned_elided_bin_lane(self, rng):
        xyz, w, _ = random_cap_catalog(rng, 1500, 1)
        patches = simple_patches(xyz, 4, rng)
        ts = build_tile_set(
            xyz, patches, 4, weights=w, zbins=None, num_bins=0,
            tile_size=64,
        )
        host = self._assert_fused_matches_split(ts)
        assert host.zbins.shape[-1] == 0

    def test_wide_binning_int16_lane(self, rng):
        num_bins = 200
        xyz, w, _ = random_cap_catalog(rng, 1500, 1)
        z = rng.integers(0, num_bins, len(xyz))
        patches = simple_patches(xyz, 4, rng)
        ts = build_tile_set(
            xyz, patches, 4, weights=w, zbins=z, num_bins=num_bins,
            tile_size=64,
        )
        host = self._assert_fused_matches_split(ts)
        assert host.zbins.dtype == np.int16

    def test_padded_tile_axis(self, rng):
        xyz, w, z = random_cap_catalog(rng, 900, 2)
        patches = simple_patches(xyz, 3, rng)
        ts = build_tile_set(
            xyz, patches, 3, weights=w, zbins=z, num_bins=2, tile_size=64
        )
        self._assert_fused_matches_split(ts, padded_tiles=ts.num_tiles + 7)

    def test_device_data_mode_switch(self, rng, monkeypatch):
        """device_data under both YAWT_LANE_UPLOAD modes yields the same
        decoded lanes (and the env value is validated)."""
        import yet_another_wizz_tpu.ops.tiles as tiles_mod

        xyz, w, z = random_cap_catalog(rng, 800, 2)
        patches = simple_patches(xyz, 3, rng)

        def fresh():
            return build_tile_set(
                xyz, patches, 3, weights=w, zbins=z, num_bins=2,
                tile_size=64,
            )

        monkeypatch.setenv(tiles_mod.LANE_UPLOAD_ENV, "fused")
        fused = np.asarray(fresh().device_data())
        monkeypatch.setenv(tiles_mod.LANE_UPLOAD_ENV, "split")
        split = np.asarray(fresh().device_data())
        assert np.array_equal(fused.view(np.uint32), split.view(np.uint32))

        monkeypatch.setenv(tiles_mod.LANE_UPLOAD_ENV, "bogus")
        with pytest.raises(ValueError, match="YAWT_LANE_UPLOAD"):
            tiles_mod.lane_upload_mode()
