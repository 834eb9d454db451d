#!/usr/bin/env python3
"""End-to-end benchmark: mock clustering-redshift measurements on the GPU
versus the multiprocess CPU reference implementation.

Workloads (BASELINE.md): ``wsp_jackknife`` (w_sp pair counts DD + RD on a
deterministic mock survey with 64 k-means patches, plus the jackknife
n(z)), ``wss_landy_szalay``, ``multiscale_rweight``, ``healpix_randoms``,
``stress_256_patches`` and the blocked out-of-core ``survey_scale``. The
CPU baseline runs the identical DD + RD counts through float64 scipy
kd-trees in a process pool — the same native kernel and parallelism
strategy as the reference package — and doubles as the float64 oracle
check of the device counts.

Needs a GPU: on any other backend it exits non-zero without a result.
Every wall it records is named by the device it ran on. Prints exactly
one JSON line to stdout; diagnostics go to stderr.

    python bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sanitize_record(obj):
    """Return a strict-JSON-safe copy of a bench record: numpy scalars
    and arrays become native Python values, and any non-finite float
    (live-computed NaN/Inf would make ``json.dumps`` happily emit
    invalid JSON) becomes ``None``: nothing may enter the emitted line
    that a strict parser rejects."""
    if isinstance(obj, dict):
        return {str(key): sanitize_record(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_record(value) for value in obj]
    if isinstance(obj, np.ndarray):
        return sanitize_record(obj.tolist())
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        value = float(obj)
        return value if np.isfinite(value) else None
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)


def _reject_constant(name: str):
    raise ValueError(f"non-strict JSON constant {name!r} in bench record")


def emit_record(result: dict, full_record_path: str | None = None) -> str:
    """Serialise the bench record parse-proof and return the stdout line.

    Sanitises every value (:func:`sanitize_record`), serialises with
    ``allow_nan=False`` so a missed non-finite float fails HERE instead
    of producing an unparseable artifact, and self-verifies with a
    strict ``json.loads`` round-trip (``parse_constant`` rejects
    NaN/Infinity spellings) before anything is printed. When
    ``full_record_path`` is given the full record is also written there,
    so the numbers survive a reader that drops the stdout line.
    """
    clean = sanitize_record(result)
    line = json.dumps(clean, allow_nan=False, separators=(",", ":"))
    json.loads(line, parse_constant=_reject_constant)  # strict round-trip
    if full_record_path is not None:
        with open(full_record_path, "w") as f:
            json.dump(clean, f, allow_nan=False, indent=1)
            f.write("\n")
    return line


BLOCKED_TOP_PHASES = (
    "rows", "cols", "pairs", "queue", "drain", "preamble", "teardown"
)
"""Top-level phases of the blocked loop's own clock (sub-phases like
``drain_wait``/``drain_fetch`` nest inside ``drain`` and are excluded
from wall sums)."""


def per_run_phases(totals: dict, num_runs: int) -> dict:
    """Per-run phase means from accumulated phase totals.

    ``totals`` holds summed blocked-loop phase timers plus the
    measurement-level ``corr_wall``/``post`` accumulators; counters
    (``num_block_pairs``, ``candidate_pairs``) are dropped. ``setup`` is
    derived as the measurement wall not covered by the blocked loop's
    own clock (catalog open, linkage, normalisation — on the phase clock
    since round 5)."""
    num_runs = max(num_runs, 1)
    phases = {
        key: round(value / num_runs, 2)
        for key, value in totals.items()
        if key not in ("num_block_pairs", "candidate_pairs")
    }
    phases["setup"] = round(
        max(
            phases.pop("corr_wall", 0.0)
            - sum(phases.get(key, 0.0) for key in BLOCKED_TOP_PHASES),
            0.0,
        ),
        2,
    )
    return phases



WARM_RUNS = 5
"""Warm repetitions of each sub-second workload."""

SURVEY_WARM_RUNS = 3
"""Warm repetitions of the 7M-row blocked workload."""


def timed_median(fn, runs: int = WARM_RUNS):
    """Median + spread of ``runs`` warm wall-clock timings."""
    times = []
    result = None
    for _ in range(runs):
        t0 = time.perf_counter()
        result = fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), min(times), max(times), result


def require_gpu(jax) -> dict:
    """The device record every wall is labelled with; no CPU fallback."""
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py: no GPU found (JAX runs on "
            f"'{jax.default_backend()}'); it measures the GPU only"
        )
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_line() -> str:
    """``nvidia-smi`` name and power limit, from a child off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


NUM_REFERENCE = 200_000
NUM_UNKNOWN = 500_000
NUM_RANDOMS = 1_000_000
NUM_PATCHES = 64
NUM_BINS = 11

SURVEY_REFERENCE = 1_000_000
SURVEY_UNKNOWN = 2_000_000
SURVEY_RANDOMS = 4_000_000
SURVEY_PATCHES = 96
SURVEY_RESIDENT = 24


def run_survey_scale() -> dict:
    """BASELINE config #5, one-device portion: 7M rows (1M reference +
    2M unknown + 4M HealPix-mask randoms), 96 patches, streamed through
    the blocked out-of-core engine path (``max_resident_patches``).

    The catalogs are disk-cached (the production pattern at survey
    scale): the persistent packed-tile store then serves every warm
    run's row/column blocks from disk; the cold run pays the one-time
    packing and store write. The warm wall is split into setup (catalog
    and linkage), the blocked loop's phase timers and the n(z)
    post-processing."""
    import shutil
    import tempfile

    from yet_another_wizz_tpu import Catalog, Configuration
    from yet_another_wizz_tpu.correlation import blocked
    from yet_another_wizz_tpu.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu.examples import generate_mock_data
    from yet_another_wizz_tpu.randoms import HealPixRandoms
    from yet_another_wizz_tpu.redshifts import RedshiftData
    from yet_another_wizz_tpu.utils import devicemem
    from yet_another_wizz_tpu.utils.healpix import pix2ang_ring

    t0 = time.perf_counter()
    cache_root = tempfile.mkdtemp(prefix="yawt_bench_survey_")
    mock = generate_mock_data(
        num_reference=SURVEY_REFERENCE,
        num_unknown=SURVEY_UNKNOWN,
        num_randoms=1,  # randoms drawn from the HealPix mask instead
        seed=777,
    )
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=SURVEY_PATCHES,
        cache_directory=os.path.join(cache_root, "reference"),
    )
    centers = reference.get_centers()
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers,
        cache_directory=os.path.join(cache_root, "unknown"),
    )
    nside = 128
    colat, lon = pix2ang_ring(nside, np.arange(12 * nside * nside))
    pix_ra_deg = np.rad2deg(lon)
    pix_dec_deg = 90.0 - np.rad2deg(colat)
    mask = (
        (pix_ra_deg >= 40.0) & (pix_ra_deg <= 60.0)
        & (pix_dec_deg >= -10.0) & (pix_dec_deg <= 10.0)
    ).astype(float)
    generator = HealPixRandoms(
        mask, redshifts=mock["reference"]["redshifts"], seed=199
    )
    randoms = Catalog.from_random(
        os.path.join(cache_root, "randoms"), generator, SURVEY_RANDOMS,
        patch_centers=centers,
    )
    log(f"survey-scale setup (7M rows, cached): {time.perf_counter() - t0:.1f}s")

    config = Configuration.create(
        rmin=100, rmax=1000, unit="kpc",
        zmin=0.15, zmax=1.0, num_bins=NUM_BINS,
    )
    # every second of a run's wall lands in exactly one bucket: setup
    # (corr wall minus the blocked loop's own clock), the blocked phases,
    # or the n(z) post-processing
    timers = {"corr_wall": 0.0, "post": 0.0}

    def run():
        t0 = time.perf_counter()
        (w_sp,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms,
            max_resident_patches=SURVEY_RESIDENT,
        )
        t1 = time.perf_counter()
        nz = RedshiftData.from_corrfuncs(w_sp)
        timers["corr_wall"] += t1 - t0
        timers["post"] += time.perf_counter() - t1
        return nz

    t0 = time.perf_counter()
    run()
    log(f"survey-scale (cold, incl. compile): {time.perf_counter() - t0:.2f}s")

    blocked.reset_phase_totals()
    devicemem.reset_peak()
    timers.update(corr_wall=0.0, post=0.0)
    t_sv, lo, hi, nz = timed_median(run, runs=SURVEY_WARM_RUNS)
    phases = per_run_phases(
        {**blocked.PHASE_TOTALS, **timers}, SURVEY_WARM_RUNS
    )
    device_resident = devicemem.snapshot()
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    pairs = sum(
        links.engine_work_stats(cat1, cat2, binned2=False)["candidate_pairs"]
        for cat1, cat2 in ((reference, unknown), (randoms, unknown))
    )
    log(
        f"survey-scale config (7M rows, HealPix-mask randoms, blocked "
        f"max_resident_patches={SURVEY_RESIDENT}): {t_sv:.2f}s warm median "
        f"[{lo:.2f}, {hi:.2f}], {pairs:.3e} candidate pairs, "
        f"n(z) finite: {bool(np.all(np.isfinite(nz.data)))}, "
        f"phases/run {phases}"
    )
    out = {
        "rows": SURVEY_REFERENCE + SURVEY_UNKNOWN + SURVEY_RANDOMS,
        "num_patches": SURVEY_PATCHES,
        "max_resident_patches": SURVEY_RESIDENT,
        "warm_median_s": [round(t_sv, 3), round(lo, 3), round(hi, 3)],
        "pairs_per_s": round(pairs / t_sv, 1),
        "phases_per_run_s": phases,
        "resident_device_bytes_peak": int(device_resident["peak_bytes"]),
    }

    # repeated measurements over the same catalogs (every tomographic bin
    # reuses the reference sample) share one session tile cache, so only
    # the first measurement packs and uploads the blocks
    with blocked.measurement_tile_cache():
        run()  # populates the session cache
        t_shared, lo, hi, _ = timed_median(run, runs=SURVEY_WARM_RUNS)
    out["shared_cache_warm_s"] = [
        round(t_shared, 3), round(lo, 3), round(hi, 3)
    ]
    log(f"survey-scale with a session tile cache: {t_shared:.2f}s warm "
        f"median [{lo:.2f}, {hi:.2f}]")
    shutil.rmtree(cache_root, ignore_errors=True)
    return out


def main() -> None:
    import jax

    from yet_another_wizz_tpu import Catalog, Configuration
    from yet_another_wizz_tpu.correlation.measurements import (
        PatchLinkage,
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu.examples import generate_mock_data
    from yet_another_wizz_tpu.ops.cpu_oracle import (
        count_pairs_oracle_multiprocess,
    )
    from yet_another_wizz_tpu.ops.linkage import build_tile_pairs
    from yet_another_wizz_tpu.ops.paircount import (
        _unpack_tileset,
        count_pairs_tiles,
    )
    from yet_another_wizz_tpu.randoms import HealPixRandoms
    from yet_another_wizz_tpu.redshifts import RedshiftData
    from yet_another_wizz_tpu.utils.compile_cache import (
        enable_persistent_compile_cache,
    )
    from yet_another_wizz_tpu.utils.healpix import pix2ang_ring

    device = require_gpu(jax)
    card = card_line()
    enable_persistent_compile_cache()
    log(f"device: {device}, card: {card}")

    t0 = time.perf_counter()
    mock = generate_mock_data(
        num_reference=NUM_REFERENCE,
        num_unknown=NUM_UNKNOWN,
        num_randoms=NUM_RANDOMS,
        seed=12345,
    )
    log(f"mock generation: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES
    )
    centers = reference.get_centers()
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers
    )
    randoms = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers
    )
    log(f"catalog construction: {time.perf_counter() - t0:.1f}s")

    config = Configuration.create(
        rmin=100, rmax=1000, unit="kpc",
        zmin=0.15, zmax=1.0, num_bins=NUM_BINS,
    )
    warm_medians = {}

    def record(name, fn):
        t0 = time.perf_counter()
        fn()
        cold = time.perf_counter() - t0
        median, lo, hi, result = timed_median(fn)
        warm_medians[name] = [round(median, 4), round(lo, 4), round(hi, 4)]
        log(f"{name}: cold {cold:.2f}s, warm median of {WARM_RUNS} "
            f"{median:.4f}s [{lo:.4f}, {hi:.4f}]")
        return median, result

    def run_measurement():
        (w_sp,) = crosscorrelate(config, reference, unknown, ref_rand=randoms)
        return RedshiftData.from_corrfuncs(w_sp)

    t_device, nz = record("wsp_jackknife", run_measurement)

    # candidate pairs the engine evaluates: the SAME pruned tile-pair
    # lists the timed measurement processes
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    binning = config.binning.binning
    stats_pairs = sum(
        links.engine_work_stats(cat1, cat2, binned2=False)["candidate_pairs"]
        for cat1, cat2 in ((reference, unknown), (randoms, unknown))
    )
    pairs_per_sec = stats_pairs / t_device
    log(f"candidate pairs: {stats_pairs:.3e} -> {pairs_per_sec:.3e} pairs/s")

    # CPU baseline: identical DD + RD counts via multiprocess scipy
    # kd-trees; doubles as a float64 validation of the device counts
    log("running multiprocess CPU baseline (scipy kd-trees)...")
    edges = links.edges.edges
    t_cpu = 0.0
    max_rel_err = 0.0
    for cat1, cat2 in ((reference, unknown), (randoms, unknown)):
        ts1 = cat1.get_tiles(binning)
        ts2 = cat2.get_tiles(None)
        pairs = build_tile_pairs(ts1, ts2, links.linkage, auto=False)
        xyz1, w1, z1, p1 = _unpack_tileset(ts1)
        xyz2, w2, _, p2 = _unpack_tileset(ts2)
        t0 = time.perf_counter()
        oracle = count_pairs_oracle_multiprocess(
            xyz1, w1, z1, p1, xyz2, w2, None, p2, pairs.slot_patches, edges
        )
        t_cpu += time.perf_counter() - t0
        engine = count_pairs_tiles(ts1, ts2, pairs, links.edges.chord2_table)
        # compare the per-scale counts (cumulative differences), the
        # quantity that enters the estimators
        scale_e = links.edges.counts_to_scales(engine).sum(axis=1)
        scale_o = links.edges.counts_to_scales(oracle).sum(axis=1)
        rel = np.abs(scale_e - scale_o) / np.maximum(np.abs(scale_o), 1e-30)
        max_rel_err = max(max_rel_err, float(rel[scale_o > 0].max()))
    log(f"CPU baseline (multiprocess kd-trees): {t_cpu:.2f}s")
    log(f"device counts vs float64 oracle: max rel err {max_rel_err:.2e}")

    # reference-sample autocorrelation with RR and Landy-Szalay
    def run_autocorr():
        (w_ss,) = autocorrelate(config, reference, randoms)
        return w_ss.sample()

    record("wss_landy_szalay", run_autocorr)

    # several angular scale ranges with power-law separation weighting
    # (the direct separation-weighted engine mode)
    config_multi = Configuration.create(
        rmin=[100, 300, 500], rmax=[300, 500, 1000], unit="kpc",
        rweight=-1.0, resolution=32,
        zmin=0.15, zmax=1.0, num_bins=NUM_BINS,
    )

    def run_multiscale():
        scales = crosscorrelate(
            config_multi, reference, unknown, ref_rand=randoms
        )
        return [w.sample() for w in scales]

    record("multiscale_rweight", run_multiscale)

    # randoms drawn from a HealPix probability map
    nside = 64
    colat, lon = pix2ang_ring(nside, np.arange(12 * nside * nside))
    pix_ra_deg = np.rad2deg(lon)
    pix_dec_deg = 90.0 - np.rad2deg(colat)
    pixel_map = (
        (pix_ra_deg >= 40.0) & (pix_ra_deg <= 60.0)
        & (pix_dec_deg >= -10.0) & (pix_dec_deg <= 10.0)
    ).astype(float)
    generator = HealPixRandoms(
        pixel_map, redshifts=mock["reference"]["redshifts"], seed=99
    )
    hp_rand = Catalog.from_random(
        None, generator, NUM_RANDOMS, patch_centers=centers,
    )

    def run_healpix():
        (w_sp,) = crosscorrelate(config, reference, unknown, ref_rand=hp_rand)
        return RedshiftData.from_corrfuncs(w_sp)

    record("healpix_randoms", run_healpix)

    # 256 patches on the same mock: thousands of linked patch-pair slots
    reference_256 = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=256
    )
    centers_256 = reference_256.get_centers()
    unknown_256 = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers_256
    )
    randoms_256 = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers_256
    )

    def run_stress():
        (w_sp,) = crosscorrelate(
            config, reference_256, unknown_256, ref_rand=randoms_256
        )
        return RedshiftData.from_corrfuncs(w_sp)

    t_256, nz_256 = record("stress_256_patches", run_stress)
    log(f"n(z) corr 256 vs 64 patches: "
        f"{np.corrcoef(nz_256.data, nz.data)[0, 1]:.3f}")

    survey_scale = run_survey_scale()
    warm_medians["survey_scale"] = survey_scale["warm_median_s"]

    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    result = {
        "metric": (
            "mock w_sp(z) DD+RD + jackknife n(z) warm wall-clock "
            "(wsp_jackknife)"
        ),
        "value": round(t_device, 4),
        "unit": "s",
        "device": device,
        "card": card,
        "vs_baseline": round(t_cpu / t_device, 2),
        # the inputs of vs_baseline: the CPU baseline is re-measured live
        # and varies with the host's load
        "cpu_baseline_s": round(t_cpu, 2),
        "device_warm_s": round(t_device, 4),
        "candidate_pairs_per_s": round(pairs_per_sec, 1),
        "warm_medians_s": warm_medians,
        "warm_runs": WARM_RUNS,
        "survey_scale": survey_scale,
        "peak_device_bytes": peak,
        "oracle_max_rel_err": float(f"{max_rel_err:.3e}"),
    }
    here = os.path.dirname(os.path.abspath(__file__))
    line = emit_record(
        result, full_record_path=os.path.join(here, "BENCH_record.json")
    )
    print(line, flush=True)


if __name__ == "__main__":
    main()
