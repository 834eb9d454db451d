"""The Pallas GPU kernel (Triton route): parity with the XLA engine in the
Pallas interpreter, its padding and slot reduction, and the choice of
engine. The one test that compiles it for the card carries the ``gpu``
marker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from test_engine import (
    patch_geometry,
    random_cap_catalog,
    simple_patches,
)
from yet_another_wizz_tpu.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu.ops.paircount import (
    count_pairs_tiles,
    resolve_backend,
)
from yet_another_wizz_tpu.ops.tiles import build_tile_set


def _problem(rng, cols_binned=False, tile_size=64):
    num_bins, num_patches = 3, 4
    xyz1, w1, z1 = random_cap_catalog(rng, 1500, num_bins)
    xyz2, w2, z2 = random_cap_catalog(rng, 1200, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=tile_size,
    )
    ts2 = build_tile_set(
        xyz2, patch2, num_patches, weights=w2,
        zbins=z2 if cols_binned else None,
        num_bins=num_bins if cols_binned else 0,
        tile_size=tile_size,
    )
    edges = np.deg2rad(np.tile((0.2, 0.7, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
    return ts1, ts2, pairs, chord2


@pytest.mark.parametrize("cols_binned", [False, True])
def test_pallas_matches_xla(rng, cols_binned):
    ts1, ts2, pairs, chord2 = _problem(rng, cols_binned)
    via_xla = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    via_pallas = count_pairs_tiles(
        ts1, ts2, pairs, chord2, backend="pallas", interpret=True
    )
    # identical math: results should agree to float32 accumulation noise
    assert_allclose(via_pallas, via_xla, rtol=1e-6, atol=1e-3)


def test_pallas_single_slot_accumulation(rng):
    """Many tile pairs landing in one output slot must accumulate."""
    num_bins = 2
    xyz, w, z = random_cap_catalog(rng, 2000, num_bins, cap_deg=3.0)
    patches = np.zeros(2000, dtype=int)
    ts = build_tile_set(
        xyz, patches, 1, weights=w, zbins=z, num_bins=num_bins, tile_size=64
    )
    edges = np.deg2rad(np.tile((0.5, 2.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz, patches, 1)
    linkage = build_linkage(centers, radii, edges.max() * 1.01)
    pairs = build_tile_pairs(ts, ts, linkage, auto=True)
    assert pairs.num_slots == 1 and pairs.num_pairs > 100

    via_xla = count_pairs_tiles(ts, ts, pairs, chord2, backend="xla")
    via_pallas = count_pairs_tiles(
        ts, ts, pairs, chord2, backend="pallas", interpret=True
    )
    assert_allclose(via_pallas, via_xla, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("num_pad", [8, 32])
def test_pallas_multi_segment(rng, num_pad):
    """Padding programs (row tile -1) contribute nothing, whatever slot
    they name, and the sorted segment sum spreads the blocks over the
    slots exactly as the XLA scatter-add does."""
    from yet_another_wizz_tpu.ops.pallas_paircount import (
        pallas_partial_counts,
    )

    ts1, ts2, pairs, chord2 = _problem(rng, tile_size=32)
    num_slots_out = pairs.num_slots + 1
    tile1 = np.concatenate([pairs.tile1, np.full(num_pad, -1)])
    tile2 = np.concatenate([pairs.tile2, np.zeros(num_pad, int)])
    # padding names the dump slot; the list stays sorted
    slots = np.concatenate([pairs.slot, np.full(num_pad, pairs.num_slots)])
    got = pallas_partial_counts(
        ts1.device_data(), ts2.device_data(),
        jnp.asarray(tile1, jnp.int32), jnp.asarray(tile2, jnp.int32),
        jnp.asarray(slots, jnp.int32), jnp.asarray(chord2),
        num_slots_out=num_slots_out, cols_binned=False, interpret=True,
    )
    got = np.asarray(got, dtype=np.float64)
    expected = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    assert got.shape == (num_slots_out, *expected.shape[1:])
    assert_allclose(got[:-1], expected, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(got[-1], 0.0)


def test_pallas_refuses_cpu_without_interpret(rng):
    """No fallback: asking for the kernel where it cannot compile raises,
    and interpret mode is never inferred from the backend."""
    ts1, ts2, pairs, chord2 = _problem(rng)
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        count_pairs_tiles(ts1, ts2, pairs, chord2, backend="pallas")
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        resolve_backend("pallas")
    assert resolve_backend("pallas", interpret=True) == "pallas"


@pytest.mark.parametrize(
    "platform,direct,expected",
    [
        ("cpu", None, "xla"),
        ("gpu", None, "pallas"),
        ("gpu", (32, 2, 2, True), "xla"),
        ("rocm", None, "xla"),
    ],
)
def test_auto_backend_choice(monkeypatch, platform, direct, expected):
    """``auto`` takes the compiled kernel only on the GPU in cumulative
    mode, where it won, and never an interpreted one."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_backend("auto", direct=direct) == expected
    assert resolve_backend("xla") == "xla"


def test_pallas_needs_power_of_two_tiles(rng):
    ts1, ts2, pairs, chord2 = _problem(rng, tile_size=48)
    with pytest.raises(ValueError, match="power-of-two tile size"):
        count_pairs_tiles(
            ts1, ts2, pairs, chord2, backend="pallas", interpret=True
        )


@pytest.mark.gpu
@pytest.mark.parametrize("cols_binned", [False, True])
def test_pallas_compiled_matches_xla(rng, gpu, cols_binned, monkeypatch):
    """The kernel as compiled for the card agrees with the XLA engine.
    The suite's default platform stays the CPU, so the work is placed on
    the GPU explicitly."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(gpu):
        ts1, ts2, pairs, chord2 = _problem(rng, cols_binned)
        via_xla = count_pairs_tiles(
            ts1, ts2, pairs, chord2, backend="xla", mesh="single"
        )
        via_pallas = count_pairs_tiles(
            ts1, ts2, pairs, chord2, backend="pallas", mesh="single"
        )
    assert_allclose(via_pallas, via_xla, rtol=1e-5, atol=1e-3)


def test_empty_slot_rows_are_zero(rng):
    """A linked patch pair whose tile pairs were ALL cap-pruned has a slot
    but no pair-list entries; its output row must come back exactly zero
    from both engines."""
    from yet_another_wizz_tpu.ops.linkage import TilePairs

    num_bins, num_patches = 2, 4
    xyz1, w1, z1 = random_cap_catalog(rng, 1500, num_bins)
    xyz2, w2, _ = random_cap_catalog(rng, 2000, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1,
        num_bins=num_bins, tile_size=64,
    )
    ts2 = build_tile_set(xyz2, patch2, num_patches, weights=w2, tile_size=64)
    edges = np.deg2rad(np.tile((0.2, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)

    # craft extra slots with no tile-pair entries, interleaved at the END
    # of the slot id range (the list stays slot-sorted)
    extra = np.array([[0, 1], [1, 0], [2, 3]])
    crafted = TilePairs(
        tile1=pairs.tile1,
        tile2=pairs.tile2,
        slot=pairs.slot,
        slot_patches=np.concatenate([pairs.slot_patches, extra]),
    )
    num_real = pairs.num_slots

    for backend in ("pallas", "xla"):
        counts = count_pairs_tiles(
            ts1, ts2, crafted, chord2, backend=backend, interpret=True
        )
        assert counts.shape[0] == num_real + 3
        np.testing.assert_array_equal(counts[num_real:], 0.0)
        np.testing.assert_allclose(
            counts[:num_real],
            count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla"),
            rtol=1e-5, atol=1e-2,
        )
