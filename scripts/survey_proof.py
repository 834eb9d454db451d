#!/usr/bin/env python3
"""Out-of-core proof at real survey scale (BASELINE config #5 at full size).

The bench's recurring survey config streams 7M rows; the reference's
DEFAULT ingestion chunk alone is 16.7M rows
(/root/reference/src/yaw/catalog/readers.py:49). This script proves the
out-of-core path at 40M rows and beyond (``--rows``; 15% reference +
35% unknown + 50% HealPix-mask randoms, 128 patches):

1. ``prepare``: mock samples stream into chunked parquet files, then
   through the chunked streaming ingestion into patch caches (several
   reader chunks -> several ingestion rounds); a stride-64 downsample of
   every side is kept for the oracle cross-check.
2. ``measure`` (its own subprocess, so its peak RSS is the
   MEASUREMENT's): all three catalogs open as :class:`LazyCatalog`
   (per-patch metadata only), the blocked engine runs the full
   crosscorrelation + jackknife n(z) with host and device memory bounded
   at a patch-block pair, and the run is recorded machine-readably
   (rows, patches, ingestion/cold/warm wall, pairs/s, per-phase wall,
   peak host RSS, device memory stats).
3. In the same subprocess, the downsampled catalogs run through the
   identical measurement on the device AND the float64 scipy kd-tree
   oracle; per-scale counts must agree to 1e-6 relative, and the
   full-scale n(z) must be finite and correlate with the downsample's
   n(z).

Only the measuring subprocess uses the accelerator: the parent, which
generates and ingests the catalogs, is pinned to the CPU, since a JAX
process reserves most of the card's memory. The JSON record goes to
``--out`` (too slow for the bench loop itself). Run:

    python scripts/survey_proof.py [--rows 40000000] [--small] \
        [--out BENCH_oneshot_survey40m.json]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

NUM_PATCHES = 128
MAX_RESIDENT = 24
DOWNSAMPLE = 64
NSIDE = 128
PARQUET_CHUNK = 2_000_000
INGEST_CHUNK = 8_000_000  # several ingestion rounds at full scale


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _configuration():
    from yet_another_wizz_tpu import Configuration

    return Configuration.create(
        rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=11
    )


def _healpix_generator(reference_redshifts, seed=199):
    from yet_another_wizz_tpu.randoms import HealPixRandoms
    from yet_another_wizz_tpu.utils.healpix import pix2ang_ring

    colat, lon = pix2ang_ring(NSIDE, np.arange(12 * NSIDE * NSIDE))
    ra_deg = np.rad2deg(lon)
    dec_deg = 90.0 - np.rad2deg(colat)
    mask = (
        (ra_deg >= 40.0) & (ra_deg <= 60.0)
        & (dec_deg >= -10.0) & (dec_deg <= 10.0)
    ).astype(float)
    return HealPixRandoms(mask, redshifts=reference_redshifts, seed=seed)


def _write_parquet_chunked(path: Path, sample: dict) -> None:
    """Write one sample as parquet in bounded row groups (degrees)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(sample["ra"])
    writer = None
    try:
        for start in range(0, n, PARQUET_CHUNK):
            stop = min(start + PARQUET_CHUNK, n)
            table = pa.table(
                dict(
                    ra=np.rad2deg(sample["ra"][start:stop]),
                    dec=np.rad2deg(sample["dec"][start:stop]),
                    z=sample["redshifts"][start:stop],
                    w=sample["weights"][start:stop],
                )
            )
            if writer is None:
                writer = pq.ParquetWriter(path, table.schema)
            writer.write_table(table)
    finally:
        if writer is not None:
            writer.close()


def prepare(workdir: Path, num_rows: int) -> dict:
    """Generate, write parquet, streaming-ingest into patch caches."""
    import shutil

    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.examples import generate_mock_data

    # reruns must not trip over a previous (possibly partial) attempt
    for name in ("reference", "unknown", "randoms"):
        shutil.rmtree(workdir / f"cache_{name}", ignore_errors=True)

    num_reference = int(num_rows * 0.15)
    num_unknown = int(num_rows * 0.35)
    num_randoms = num_rows - num_reference - num_unknown

    t0 = time.perf_counter()
    log(f"generating mock samples ({num_rows} rows total)...")
    mock = generate_mock_data(
        num_reference=num_reference,
        num_unknown=num_unknown,
        num_randoms=1,  # randoms drawn from the HealPix mask below
        num_clusters=3000,
        seed=777,
    )
    generator = _healpix_generator(mock["reference"]["redshifts"])
    randoms_chunk_parts = []
    for start in range(0, num_randoms, PARQUET_CHUNK):
        n = min(PARQUET_CHUNK, num_randoms - start)
        chunk = generator(n)
        randoms_chunk_parts.append(chunk)
    from yet_another_wizz_tpu.datachunk import DataChunk

    randoms = dict(
        ra=np.concatenate([c["ra"] for c in randoms_chunk_parts]),
        dec=np.concatenate([c["dec"] for c in randoms_chunk_parts]),
        redshifts=np.concatenate(
            [DataChunk.getattr(c, "redshifts") for c in randoms_chunk_parts]
        ),
    )
    randoms["weights"] = np.ones(len(randoms["ra"]))
    del randoms_chunk_parts
    samples = dict(
        reference=mock["reference"], unknown=mock["unknown"], randoms=randoms
    )
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    downsample = {}
    for name, sample in samples.items():
        _write_parquet_chunked(workdir / f"{name}.pqt", sample)
        downsample[name] = {
            key: np.ascontiguousarray(value[::DOWNSAMPLE])
            for key, value in sample.items()
        }
    np.savez(workdir / "downsample.npz", **{
        f"{name}_{key}": arr
        for name, sub in downsample.items()
        for key, arr in sub.items()
    })
    t_write = time.perf_counter() - t0

    # patch centers from a reference-sample probe (bounded)
    probe = Catalog.from_arrays(
        samples["reference"]["ra"][:: max(1, num_reference // 500_000)],
        samples["reference"]["dec"][:: max(1, num_reference // 500_000)],
        degrees=False,
        patch_num=NUM_PATCHES,
    )
    centers = probe.get_centers()
    np.save(workdir / "centers.npy", centers.data)
    del samples, mock, randoms, probe

    t0 = time.perf_counter()
    rows = {}
    for name in ("reference", "unknown", "randoms"):
        log(f"streaming ingestion: {name}")
        catalog = Catalog.from_file(
            workdir / f"cache_{name}",
            workdir / f"{name}.pqt",
            ra_name="ra", dec_name="dec", redshift_name="z", weight_name="w",
            patch_centers=centers,
            degrees=True,
            streaming=True,
            chunksize=INGEST_CHUNK,
        )
        rows[name] = int(np.sum(catalog.get_num_records()))
        del catalog
    t_ingest = time.perf_counter() - t0
    return {
        "rows": rows,
        "generate_s": round(t_gen, 1),
        "parquet_write_s": round(t_write, 1),
        "ingest_s": round(t_ingest, 1),
    }


def store_calibration(workdir: Path) -> dict:
    """Persistent packed-tile store: total stored bytes and the
    measured sequential read rate (what the warm rows/cols phases pay
    instead of repacking)."""
    files = sorted(workdir.glob("cache_*/tiles/*/block_*.npz"))
    if not files:
        return {}
    total = sum(f.stat().st_size for f in files)
    probe = max(files, key=lambda f: f.stat().st_size)
    t0 = time.perf_counter()
    with np.load(probe) as payload:
        for key in payload.files:
            payload[key]
    read_s = time.perf_counter() - t0
    return {
        "stored_bytes": int(total),
        "read_mb_s": round(
            probe.stat().st_size / 1e6 / max(read_s, 1e-9), 1
        ),
    }


def measure(workdir: Path) -> dict:
    """The bounded-memory measurement (run in its own subprocess)."""
    import jax

    from yet_another_wizz_tpu.catalog import LazyCatalog
    from yet_another_wizz_tpu.correlation import blocked
    from yet_another_wizz_tpu.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu.redshifts import RedshiftData
    from yet_another_wizz_tpu.utils.compile_cache import (
        enable_persistent_compile_cache,
    )

    enable_persistent_compile_cache()
    config = _configuration()

    reference = LazyCatalog(workdir / "cache_reference")
    unknown = LazyCatalog(workdir / "cache_unknown")
    randoms = LazyCatalog(workdir / "cache_randoms")
    rows = int(
        np.sum(reference.get_num_records())
        + np.sum(unknown.get_num_records())
        + np.sum(randoms.get_num_records())
    )

    def run():
        (w_sp,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms,
            max_resident_patches=MAX_RESIDENT,
        )
        return w_sp, RedshiftData.from_corrfuncs(w_sp)

    from yet_another_wizz_tpu.utils import devicemem

    counters = ("num_block_pairs", "candidate_pairs")

    def captured_phases() -> dict:
        return {
            key: round(value, 2)
            for key, value in blocked.PHASE_TOTALS.items()
            if key not in counters
        }

    # cold run with its own phase attribution: the one-time cost
    # (compile + first packing incl. the persistent tile-store writes +
    # cache population) is explained the same way the warm wall is; the
    # unattributed remainder is compile/dispatch outside the blocked
    # loop's clock
    blocked.reset_phase_totals()
    t0 = time.perf_counter()
    run()
    t_cold = time.perf_counter() - t0
    cold_phases = captured_phases()
    cold_phases["unattributed"] = round(
        t_cold - sum(
            cold_phases.get(key, 0.0)
            for key in (
                "rows", "cols", "pairs", "queue", "drain", "preamble",
                "teardown",
            )
        ),
        2,
    )

    blocked.reset_phase_totals()
    devicemem.reset_peak()
    t0 = time.perf_counter()
    w_sp, nz = run()
    t_warm = time.perf_counter() - t0
    phases = captured_phases()
    device_resident = devicemem.snapshot()
    # the engine work statistic accumulated by the blocked sweep itself —
    # full-catalog tile sets (measurements.num_candidate_pairs) never
    # exist for LazyCatalogs
    pairs = int(blocked.PHASE_TOTALS["candidate_pairs"])
    num_block_pairs = int(blocked.PHASE_TOTALS["num_block_pairs"])

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    hbm = {
        key: int(value)
        for key, value in (jax.local_devices()[0].memory_stats() or {}).items()
        if "bytes" in key and isinstance(value, (int, float))
    }

    return {
        "rows": rows,
        "num_patches": int(reference.num_patches),
        "max_resident_patches": MAX_RESIDENT,
        "lazy_catalogs": True,
        "cold_wall_s": round(t_cold, 1),
        "cold_phases_s": cold_phases,
        "warm_wall_s": round(t_warm, 1),
        "candidate_pairs": float(f"{pairs:.4e}"),
        "pairs_per_s": round(pairs / t_warm, 1),
        "num_block_pairs": num_block_pairs,
        "phases_s": phases,
        "peak_host_rss_gb": round(peak_rss_gb, 2),
        "tile_store": store_calibration(workdir),
        "device_memory_stats": hbm,
        # framework-accounted resident device bytes (utils/devicemem.py),
        # by label, beside memory_stats() above (warm run window)
        "resident_device_bytes": {
            "peak": int(device_resident["peak_bytes"]),
            "peak_by_label": {
                key: int(value)
                for key, value in device_resident["peak_by_label"].items()
            },
        },
        "nz_finite": bool(np.all(np.isfinite(nz.data))),
        "nz_data": [float(f"{v:.6g}") for v in nz.data],
        "nz_error": [float(f"{v:.6g}") for v in nz.error],
    }


def crosscheck(workdir: Path) -> dict:
    """Downsample: device vs float64 oracle parity + n(z) consistency."""
    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.coordinates import AngularCoordinates
    from yet_another_wizz_tpu.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu.ops.cpu_oracle import (
        count_pairs_oracle_multiprocess,
    )
    from yet_another_wizz_tpu.ops.linkage import build_tile_pairs
    from yet_another_wizz_tpu.ops.paircount import (
        _unpack_tileset,
        count_pairs_tiles,
    )
    from yet_another_wizz_tpu.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu.redshifts import RedshiftData

    config = _configuration()
    data = np.load(workdir / "downsample.npz")
    centers = AngularCoordinates(np.load(workdir / "centers.npy"))
    catalogs = {}
    for name in ("reference", "unknown", "randoms"):
        kwargs = dict(
            weights=data[f"{name}_weights"],
            redshifts=data[f"{name}_redshifts"],
        )
        catalogs[name] = Catalog.from_arrays(
            data[f"{name}_ra"], data[f"{name}_dec"], degrees=False,
            patch_centers=centers, **kwargs,
        )

    links = PatchLinkage.from_catalogs(config, *catalogs.values())
    binning = config.binning.binning
    edges = links.edges.edges
    max_rel_err = 0.0
    for cat1, cat2 in (
        (catalogs["reference"], catalogs["unknown"]),
        (catalogs["randoms"], catalogs["unknown"]),
    ):
        ts1 = cat1.get_tiles(binning)
        ts2 = cat2.get_tiles(None)
        tile_pairs = build_tile_pairs(ts1, ts2, links.linkage, auto=False)
        xyz1, w1, z1, p1 = _unpack_tileset(ts1)
        xyz2, w2, _, p2 = _unpack_tileset(ts2)
        oracle = count_pairs_oracle_multiprocess(
            xyz1, w1, z1, p1, xyz2, w2, None, p2,
            tile_pairs.slot_patches, edges,
        )
        engine = count_pairs_tiles(
            ts1, ts2, tile_pairs, links.edges.chord2_table
        )
        scale_e = links.edges.counts_to_scales(engine).sum(axis=1)
        scale_o = links.edges.counts_to_scales(oracle).sum(axis=1)
        rel = np.abs(scale_e - scale_o) / np.maximum(np.abs(scale_o), 1e-30)
        max_rel_err = max(max_rel_err, float(rel[scale_o > 0].max()))

    (w_sp,) = crosscorrelate(
        config,
        catalogs["reference"],
        catalogs["unknown"],
        ref_rand=catalogs["randoms"],
    )
    nz = RedshiftData.from_corrfuncs(w_sp)
    return {
        "downsample_stride": DOWNSAMPLE,
        "oracle_max_rel_err": float(f"{max_rel_err:.3e}"),
        "nz_data": [float(f"{v:.6g}") for v in nz.data],
        "nz_error": [float(f"{v:.6g}") for v in nz.error],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=40_000_000)
    parser.add_argument(
        "--small", action="store_true",
        help="400k-row smoke test of the full machinery",
    )
    parser.add_argument(
        "--workdir",
        default=os.path.join(tempfile.gettempdir(), "yawt_survey_proof"),
    )
    parser.add_argument("--out", default=None)
    parser.add_argument(
        "--downsample", type=int, default=64,
        help="stride of the oracle-crosscheck downsample (raise at "
        "200M+ rows: the float64 kd-tree oracle is O(downsampled "
        "pairs) on the host)",
    )
    parser.add_argument(
        "--skip-prepare", action="store_true",
        help="reuse an existing workdir's caches/downsample (re-measure "
        "only; rows are read back from the cached catalogs)",
    )
    parser.add_argument(
        "--measure-only", action="store_true",
        help=argparse.SUPPRESS,  # internal: the measurement subprocess
    )
    args = parser.parse_args()
    global DOWNSAMPLE
    DOWNSAMPLE = args.downsample
    workdir = Path(args.workdir)

    if args.measure_only:
        print(json.dumps({
            "measure": measure(workdir), "crosscheck": crosscheck(workdir)
        }))
        return

    # the parent generates and ingests on the CPU and leaves the card to
    # the measuring subprocess, which gets the original platform choice
    child_env = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cpu"

    num_rows = 400_000 if args.small else args.rows
    workdir.mkdir(parents=True, exist_ok=True)

    record = {"config": "survey_proof", "total_rows_requested": num_rows}
    if args.skip_prepare:
        # re-measurement over an existing workdir: carry the original
        # run's prepare statistics forward when the record exists
        record["prepare"] = {"reused_existing_workdir": True}
        if args.out and Path(args.out).exists():
            previous = json.loads(Path(args.out).read_text())
            if "prepare" in previous:
                record["prepare"] = dict(
                    previous["prepare"], reused_existing_workdir=True
                )
    else:
        record["prepare"] = prepare(workdir, num_rows)
    log(f"prepare: {record['prepare']}")

    # the measurement runs in its own subprocess so peak RSS is ITS
    # high-water mark, not the generation phase's
    result = subprocess.run(
        [sys.executable, __file__, "--measure-only", "--workdir", str(workdir),
         "--downsample", str(DOWNSAMPLE)],
        capture_output=True, text=True, timeout=14400, env=child_env,
    )
    sys.stderr.write(result.stderr)
    if result.returncode != 0:
        raise RuntimeError(f"measurement subprocess failed:\n{result.stderr}")
    record.update(json.loads(result.stdout.strip().splitlines()[-1]))
    log(f"measure: {record['measure']}")
    log(f"crosscheck: {record['crosscheck']}")

    # consistency gates
    assert record["measure"]["nz_finite"], "full-scale n(z) not finite"
    assert record["crosscheck"]["oracle_max_rel_err"] < 1e-6, (
        "downsample device counts diverge from the float64 oracle"
    )
    full = np.array(record["measure"]["nz_data"])
    down = np.array(record["crosscheck"]["nz_data"])
    err = np.hypot(
        np.array(record["measure"]["nz_error"]),
        np.array(record["crosscheck"]["nz_error"]),
    )
    # error-aware consistency: the downsampled n(z) must agree with the
    # full-scale n(z) within their combined jackknife errors (a plain
    # correlation gate is meaningless at smoke-test statistics, where the
    # stride-64 sample keeps only ~1k reference objects)
    chi2 = float(np.mean(((full - down) / err) ** 2))
    record["nz_full_vs_downsample_chi2"] = round(chi2, 3)
    record["nz_full_vs_downsample_corr"] = round(
        float(np.corrcoef(full, down)[0, 1]), 4
    )
    assert chi2 < 3.0, (
        f"full vs downsampled n(z) inconsistent (reduced chi2={chi2:.2f})"
    )

    record["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())
    out = args.out or (
        REPO / ("BENCH_oneshot_survey40m.json" if not args.small else
                Path(tempfile.gettempdir()) / "survey_proof_small.json")
    )
    Path(out).write_text(json.dumps(record, indent=1) + "\n")
    log(f"record written: {out}")


if __name__ == "__main__":
    main()
