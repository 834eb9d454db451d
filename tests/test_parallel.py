"""Multi-device sharded pair counting on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest
from numpy.testing import assert_allclose

from test_engine import patch_geometry, random_cap_catalog, simple_patches
from yet_another_wizz_tpu.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu.ops.tiles import build_tile_set
from yet_another_wizz_tpu.parallel import count_pairs_sharded, default_mesh


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(12345)
    num_bins, num_patches = 3, 5
    xyz1, w1, z1 = random_cap_catalog(rng, 3000, num_bins)
    xyz2, w2, _ = random_cap_catalog(rng, 4000, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=64,
    )
    ts2 = build_tile_set(xyz2, patch2, num_patches, weights=w2, tile_size=64)
    edges = np.deg2rad(np.tile((0.2, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
    return ts1, ts2, pairs, chord2


def test_virtual_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("data_sharding", ["replicated", "columns", "ring"])
def test_sharded_matches_single_device(problem, data_sharding):
    ts1, ts2, pairs, chord2 = problem
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    for n_dev in (2, 8):
        mesh = default_mesh(n_dev)
        sharded = count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=data_sharding
        )
        assert_allclose(sharded, single, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("data_sharding", ["replicated", "columns", "ring"])
def test_sharded_elided_weight_lane(problem, data_sharding):
    """Unit-weight catalogs cross the link with the weight lane elided
    (ops/tiles.py:uniform_weight_fill); every sharded layout must decode
    the reconstructed lane to the same counts as the float64-equivalent
    single-device run with explicit unit weights."""
    rng = np.random.default_rng(777)
    num_bins, num_patches = 3, 5
    xyz1, _, z1 = random_cap_catalog(rng, 3000, num_bins)
    xyz2, _, _ = random_cap_catalog(rng, 4000, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=np.ones(len(xyz1)), zbins=z1,
        num_bins=num_bins, tile_size=64,
    )
    ts2 = build_tile_set(
        xyz2, patch2, num_patches, weights=np.ones(len(xyz2)), tile_size=64
    )
    assert ts1.host_lanes().data.shape[1] == 3  # elision active
    edges = np.deg2rad(np.tile((0.2, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)

    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    mesh = default_mesh(8)
    sharded = count_pairs_sharded(
        ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=data_sharding
    )
    assert_allclose(sharded, single, rtol=1e-5, atol=1e-2)


def test_column_sharding_distributes_tiles(problem):
    """With column sharding every device holds only its shard of the
    column catalog (the memory-scaling property)."""
    ts1, ts2, pairs, chord2 = problem
    mesh = default_mesh(8)
    sharded = count_pairs_sharded(
        ts1, ts2, pairs, chord2, mesh=mesh, data_sharding="columns"
    )
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    assert_allclose(sharded, single, rtol=1e-5, atol=1e-2)
    with pytest.raises(ValueError, match="data_sharding"):
        count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding="rows"
        )


def test_ring_sharding_auto_binned(problem):
    """Ring rotation with a binned column catalog (autocorrelation-style
    counting) and a mesh size that does not divide the tile count."""
    rng = np.random.default_rng(4242)
    num_bins, num_patches = 2, 4
    xyz, w, z = random_cap_catalog(rng, 2500, num_bins)
    patch = simple_patches(xyz, num_patches, np.random.default_rng(3))
    ts = build_tile_set(
        xyz, patch, num_patches, weights=w, zbins=z, num_bins=num_bins,
        tile_size=64,
    )
    edges = np.deg2rad(np.tile((0.2, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz, patch, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts, ts, linkage, auto=True)
    single = count_pairs_tiles(ts, ts, pairs, chord2, backend="xla")
    for n_dev in (3, 8):
        mesh = default_mesh(n_dev)
        ring = count_pairs_sharded(
            ts, ts, pairs, chord2, mesh=mesh, data_sharding="ring"
        )
        assert_allclose(ring, single, rtol=1e-5, atol=1e-2)


def test_shard_ownership_balanced(problem):
    """Ownership follows the logical (unbucketed) tile split: with more
    tiles than devices, every device owns tiles — bucketing the ownership
    stride would concentrate all tiles on the first devices and idle the
    rest (regression test for exactly that bug)."""
    from yet_another_wizz_tpu.parallel.sharded import _shard_tiles

    ts1, ts2, pairs, chord2 = problem
    num_tiles2 = len(ts2.lane_data)
    assert num_tiles2 >= 8  # fixture sanity: enough tiles to spread
    blocks, logical, shard = _shard_tiles(ts2.lane_data, 8)
    assert logical == -(-num_tiles2 // 8)
    assert shard >= logical and len(blocks) == 8 * shard
    # every device's block holds its logical tile range at offset 0
    for device in range(8):
        chunk = ts2.lane_data[device * logical : (device + 1) * logical]
        np.testing.assert_array_equal(
            blocks[device * shard : device * shard + len(chunk)], chunk
        )
    owner = np.minimum(pairs.tile2 // logical, 7)
    assert len(np.unique(owner)) == 8


def test_sharded_odd_chunk_size(problem):
    """Bucketed pair-list padding stays reshapeable for chunk sizes that
    do not divide the quarter-octave grid points."""
    ts1, ts2, pairs, chord2 = problem
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    mesh = default_mesh(4)
    for data_sharding in ("replicated", "columns", "ring"):
        sharded = count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh,
            data_sharding=data_sharding, chunk_size=24,
        )
        assert_allclose(sharded, single, rtol=1e-5, atol=1e-2)


def test_xla_backend_odd_chunk_size(problem):
    ts1, ts2, pairs, chord2 = problem
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    odd = count_pairs_tiles(
        ts1, ts2, pairs, chord2, backend="xla", chunk_size=24
    )
    assert_allclose(odd, single, rtol=1e-6, atol=1e-2)


def test_graft_entry_contract():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import __graft_entry__ as graft

    fn, example_args = graft.entry()
    compiled = jax.jit(fn).lower(*example_args).compile()
    out = compiled(*example_args)
    assert np.all(np.isfinite(np.asarray(out)))


def test_graft_dryrun_multichip():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


class TestDistributedHelpers:
    """Single-process degradation of the multi-host helpers."""

    def test_single_process_semantics(self):
        from yet_another_wizz_tpu import parallel

        parallel.initialize()
        assert parallel.process_index() == 0
        assert parallel.num_processes() == 1
        assert parallel.on_root()
        parallel.barrier()  # no-op
        payload = {"config": [1, 2, 3]}
        assert parallel.broadcast(payload) == payload

    def test_multihost_after_single_host_latch_raises(self):
        """Once an argument-less initialize() latched single-host mode, a
        later multi-host call must fail loudly — a silent no-op would
        strand this process outside the cluster its peers are joining."""
        from yet_another_wizz_tpu.parallel import distributed

        distributed.initialize()  # latch (idempotent if already latched)
        with pytest.raises(RuntimeError, match="single-host"):
            distributed.initialize(
                coordinator_address="127.0.0.1:9",
                process_count=2,
                process_id=1,
            )
        distributed.initialize()  # argument-less call stays a no-op

    def test_launched_world_size_detection(self, monkeypatch):
        """MPI-style launcher environments are recognised (the reference's
        mpirun auto-detection); a single-rank launch or no launcher means
        single-host."""
        from yet_another_wizz_tpu.parallel import distributed

        for var in distributed._LAUNCHER_WORLD_SIZE_VARS:
            monkeypatch.delenv(var, raising=False)
        assert distributed._launched_world_size() is None

        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
        assert distributed._launched_world_size() == 4
        monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")

        monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "garbage")
        assert distributed._launched_world_size() is None
        monkeypatch.delenv("SLURM_STEP_NUM_TASKS")

        # sbatch exports SLURM_NTASKS into the batch step itself, where
        # only one process exists — it must NOT trigger cluster detection
        monkeypatch.setenv("SLURM_NTASKS", "4")
        assert distributed._launched_world_size() is None

    def test_launcher_after_single_host_latch_raises(self, monkeypatch):
        """An argument-less initialize() under a multi-rank launcher
        environment must not silently no-op after a single-host latch —
        that would strand this rank outside the cluster."""
        from yet_another_wizz_tpu.parallel import distributed

        distributed.initialize()  # latch (idempotent if already latched)
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="single-host"):
            distributed.initialize()
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
        distributed.initialize()  # single-rank launcher: still a no-op


def test_sharded_empty_pairs_result_shape(problem):
    """An empty pair list returns the same result shape as the
    single-device engine — in direct mode the edge axis covers only the
    counting columns, not the appended parameter block."""
    from yet_another_wizz_tpu.ops.gweight import counting_width, num_param_cols
    from yet_another_wizz_tpu.ops.linkage import TilePairs

    ts1, ts2, _, chord2 = problem
    empty = TilePairs(
        tile1=np.zeros(0, np.int32),
        tile2=np.zeros(0, np.int32),
        slot=np.zeros(0, np.int32),
        slot_patches=np.array([[0, 0], [1, 1]]),
    )
    mesh = default_mesh(2)

    out = count_pairs_sharded(ts1, ts2, empty, chord2, mesh=mesh)
    single = count_pairs_tiles(ts1, ts2, empty, chord2, backend="xla")
    assert out.shape == single.shape == (2, *chord2.shape)
    assert not out.any()

    direct = (chord2.shape[1], 1, 1)
    combined = np.concatenate(
        [chord2, np.zeros((chord2.shape[0], num_param_cols(1, 1)), np.float32)],
        axis=1,
    )
    out_d = count_pairs_sharded(
        ts1, ts2, empty, combined, mesh=mesh, direct=direct
    )
    single_d = count_pairs_tiles(
        ts1, ts2, empty, combined, backend="xla", direct=direct
    )
    width = counting_width(combined.shape[1], direct)
    assert out_d.shape == single_d.shape == (2, chord2.shape[0], width)


def test_mesh_through_measurement_api():
    """`crosscorrelate(mesh=...)` runs the sharded engine and matches the
    single-device measurement."""
    from yet_another_wizz_tpu import Catalog, Configuration
    from yet_another_wizz_tpu.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=1500, num_unknown=2500, num_randoms=5000, seed=11
    )
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=4
    )
    centers = reference.get_centers()
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers
    )
    randoms = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers
    )
    config = Configuration.create(
        rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
    )
    (single,) = crosscorrelate(
        config, reference, unknown, ref_rand=randoms, backend="xla"
    )
    for sharding in ("columns", "ring"):
        (sharded,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms,
            mesh=default_mesh(8), data_sharding=sharding,
        )
        assert_allclose(
            sharded.dd.counts.counts, single.dd.counts.counts,
            rtol=1e-5, atol=1e-2,
        )
        assert_allclose(
            sharded.sample().data, single.sample().data, rtol=1e-4
        )


def test_mesh_with_blocked_mode():
    """Out-of-core blocking combines with mesh-sharded block execution."""
    from yet_another_wizz_tpu import Catalog, Configuration
    from yet_another_wizz_tpu.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu.examples import generate_mock_data

    mock = generate_mock_data(1200, 1800, 3000, seed=2)
    ref = Catalog.from_arrays(**mock["reference"], degrees=False, patch_num=5)
    unk = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=ref.get_centers()
    )
    rand = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=ref.get_centers()
    )
    config = Configuration.create(
        rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=3
    )
    (single,) = crosscorrelate(
        config, ref, unk, ref_rand=rand, backend="xla"
    )
    (blocked_sharded,) = crosscorrelate(
        config, ref, unk, ref_rand=rand, backend="xla",
        mesh=default_mesh(4), data_sharding="ring",
        max_resident_patches=4,
    )
    assert_allclose(
        blocked_sharded.dd.counts.counts, single.dd.counts.counts,
        rtol=1e-5, atol=1e-2,
    )
    assert_allclose(
        blocked_sharded.sample().data, single.sample().data, rtol=1e-4
    )


@pytest.mark.parametrize("data_sharding", ["replicated", "columns", "ring"])
def test_sharded_pallas_engine_matches_xla(problem, data_sharding):
    """The per-device Pallas kernel (interpret mode on CPU) produces the
    same sharded counts as the portable XLA scatter-add engine."""
    ts1, ts2, pairs, chord2 = problem
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    mesh = default_mesh(4)
    sharded = count_pairs_sharded(
        ts1, ts2, pairs, chord2, mesh=mesh,
        data_sharding=data_sharding, engine="pallas", interpret=True,
    )
    assert_allclose(sharded, single, rtol=1e-5, atol=1e-2)


class TestAutoMesh:
    """Automatic device-pool detection (VERDICT r2 item 1): single-process
    multi-device jobs must engage all local chips by default."""

    def test_cpu_backend_defaults_single_device(self, monkeypatch):
        from yet_another_wizz_tpu.parallel import auto_mesh

        monkeypatch.delenv("YAWT_NUM_DEVICES", raising=False)
        assert auto_mesh() is None  # virtual CPU devices are not chips

    def test_env_override_engages_devices(self, monkeypatch):
        from yet_another_wizz_tpu.parallel import auto_mesh

        monkeypatch.setenv("YAWT_NUM_DEVICES", "8")
        mesh = auto_mesh()
        assert mesh is not None and mesh.devices.size == 8
        monkeypatch.setenv("YAWT_NUM_DEVICES", "3")
        assert auto_mesh().devices.size == 3
        monkeypatch.setenv("YAWT_NUM_DEVICES", "1")
        assert auto_mesh() is None

    def test_malformed_env_degrades_to_default(self, monkeypatch, caplog):
        """A broken tuning knob must not abort a measurement: malformed
        YAWT_NUM_DEVICES warns and falls back to the backend default
        (no pool on virtual CPU devices)."""
        from yet_another_wizz_tpu.parallel import auto_mesh

        monkeypatch.setenv("YAWT_NUM_DEVICES", "all")
        with caplog.at_level("WARNING"):
            assert auto_mesh() is None
        assert "YAWT_NUM_DEVICES" in caplog.text

    @pytest.mark.parametrize("chunk", [8, 24, 1000])
    def test_pad_chunk_length_odd_chunk_above_segment_bound(self, chunk):
        """Per-device pair lists pad to a chunk multiple for the XLA scan,
        on the shared bucket grid, whatever the chunk size."""
        from yet_another_wizz_tpu.parallel.sharded import _pad_chunk_length

        for n in (1, 70_000, 200_001):
            length = _pad_chunk_length(n, chunk)
            assert length % chunk == 0
            assert length >= n
            assert length <= max(1.25 * n + chunk, 16 * chunk)

    def test_bare_engine_call_engages_all_devices(self, problem, monkeypatch):
        """`count_pairs_tiles` without an explicit mesh must route through
        the sharded engine over the full device pool (all 8 virtual
        devices here), producing identical counts."""
        import yet_another_wizz_tpu.parallel as parallel
        from yet_another_wizz_tpu.parallel.sharded import MESH_AXIS

        ts1, ts2, pairs, chord2 = problem
        single = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")

        seen = {}
        real = parallel.count_pairs_sharded

        def recorder(*args, **kwargs):
            seen["mesh"] = kwargs.get("mesh")
            return real(*args, **kwargs)

        monkeypatch.setenv("YAWT_NUM_DEVICES", "8")
        monkeypatch.setattr(parallel, "count_pairs_sharded", recorder)
        auto = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")

        mesh = seen["mesh"]
        assert mesh is not None and mesh.devices.size == 8
        assert mesh.axis_names == (MESH_AXIS,)
        assert set(mesh.devices.ravel()) == set(jax.devices())
        assert_allclose(auto, single, rtol=1e-5, atol=1e-2)

    def test_measurement_api_engages_all_devices(self, monkeypatch):
        """`crosscorrelate` without a mesh argument engages the automatic
        device pool (the single-process, several-GPU scenario)."""
        import yet_another_wizz_tpu.parallel as parallel
        from yet_another_wizz_tpu import Catalog, Configuration
        from yet_another_wizz_tpu.correlation.measurements import (
            crosscorrelate,
        )
        from yet_another_wizz_tpu.examples import generate_mock_data

        mock = generate_mock_data(800, 1200, 2000, seed=7)
        ref = Catalog.from_arrays(
            **mock["reference"], degrees=False, patch_num=4
        )
        unk = Catalog.from_arrays(
            **mock["unknown"], degrees=False,
            patch_centers=ref.get_centers(),
        )
        rand = Catalog.from_arrays(
            **mock["randoms"], degrees=False,
            patch_centers=ref.get_centers(),
        )
        config = Configuration.create(
            rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0,
            num_bins=3,
        )
        (single,) = crosscorrelate(
            config, ref, unk, ref_rand=rand, backend="xla"
        )

        meshes = []
        real = parallel.count_pairs_sharded

        def recorder(*args, **kwargs):
            meshes.append(kwargs.get("mesh"))
            return real(*args, **kwargs)

        monkeypatch.setenv("YAWT_NUM_DEVICES", "8")
        monkeypatch.setattr(parallel, "count_pairs_sharded", recorder)
        # fresh catalog instances: ensure_unique_catalogs requires it and
        # the cached device tiles of the run above stay untouched
        ref2 = Catalog.from_arrays(
            **mock["reference"], degrees=False,
            patch_centers=ref.get_centers(),
        )
        unk2 = Catalog.from_arrays(
            **mock["unknown"], degrees=False,
            patch_centers=ref.get_centers(),
        )
        rand2 = Catalog.from_arrays(
            **mock["randoms"], degrees=False,
            patch_centers=ref.get_centers(),
        )
        (auto,) = crosscorrelate(
            config, ref2, unk2, ref_rand=rand2, backend="xla"
        )
        assert meshes and all(m.devices.size == 8 for m in meshes)
        assert_allclose(
            auto.dd.counts.counts, single.dd.counts.counts,
            rtol=1e-5, atol=1e-2,
        )
        assert_allclose(auto.sample().data, single.sample().data, rtol=1e-4)
