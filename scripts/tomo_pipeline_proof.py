#!/usr/bin/env python3
"""Survey-scale TOMOGRAPHIC proof through the production CLI pipeline.

The out-of-core proof (``scripts/survey_proof.py``) drives a single
cross-correlation through the library API; real clustering-
redshift production runs the CLI task DAG over TOMOGRAPHIC bins — the
reference's headline workflow (``yaw_cli``: ingestion -> auto_ref with RR
-> one cross-correlation per tomographic slice -> estimate -> true n(z);
/root/reference/src/yaw/cli/tasks.py:8-17). This script proves that shape
at survey scale on the accelerator:

1. ``prepare``: a deterministic mock (reference 15%, unknown 35% split
   into ``--bins`` tomographic slices by redshift quantile, randoms 50%)
   streams into chunked parquet files, plus stride-``DOWNSAMPLE`` copies
   of every file for the consistency gate.
2. The REAL CLI entry point (``python -m
   yet_another_wizz_tpu.cli.commandline``) runs the full task DAG in its
   own subprocess (so peak RSS is the pipeline's): kmeans patch centers,
   streaming ingestion of every catalog, auto_ref (DD/DR/RR), per-bin
   cross-correlations (DD/RD), estimates, and true-n(z) histograms, with
   the blocked out-of-core engine and lazy catalogs
   (``execution: {max_resident_patches, lazy}``) and the session tile
   cache the pipeline installs around its task list. Per-task walls are
   parsed from ``pipeline.log``.
3. The identical setup runs on the downsampled inputs; every bin's
   estimated n(z) must be finite and agree with the downsample within
   the combined jackknife errors (error-aware reduced chi^2, the same
   gate as ``scripts/survey_proof.py``).

Only the pipeline subprocesses use the accelerator: this parent process
is pinned to the CPU, since a JAX process reserves most of the card's
memory. The JSON record goes to ``--out``. Run:

    python scripts/tomo_pipeline_proof.py [--rows 30000000] [--bins 4] \
        [--small] [--out BENCH_oneshot_tomo30m.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the pipeline subprocesses get the original platform choice; main()
# keeps this process off the card
CHILD_ENV = dict(os.environ)

import numpy as np  # noqa: E402

NUM_PATCHES = 96
MAX_RESIDENT = 24
DOWNSAMPLE = 64
PARQUET_CHUNK = 2_000_000
TASKS = ["auto_ref", "cross_corr", "estimate", "hist"]


def set_smoke_scale() -> None:
    """--small: keep every patch populated at smoke-test statistics."""
    global NUM_PATCHES, MAX_RESIDENT, DOWNSAMPLE
    NUM_PATCHES = 16
    MAX_RESIDENT = 6
    DOWNSAMPLE = 8


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


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


def prepare(workdir: Path, num_rows: int, num_bins: int) -> dict:
    """Generate the mock, slice the unknown tomographically, write parquet."""
    from yet_another_wizz_tpu.examples import generate_mock_data

    num_reference = int(num_rows * 0.15)
    num_unknown = int(num_rows * 0.35)
    num_randoms = num_rows - num_reference - num_unknown

    t0 = time.perf_counter()
    log(f"generating mock samples ({num_rows} rows total)...")
    mock = generate_mock_data(
        num_reference=num_reference,
        num_unknown=num_unknown,
        num_randoms=num_randoms,
        num_clusters=3000,
        seed=779,
    )
    t_gen = time.perf_counter() - t0

    # tomographic slices: quantiles of the unknown sample's redshifts
    # (each slice keeps its TRUE redshifts for the hist task; production
    # photometric bins are broader, which only weakens the signal)
    unknown = mock["unknown"]
    quantiles = np.quantile(
        unknown["redshifts"], np.linspace(0.0, 1.0, num_bins + 1)
    )
    sources = {name: mock[name] for name in ("reference", "randoms")}
    for index in range(1, num_bins + 1):
        lo, hi = quantiles[index - 1], quantiles[index]
        upper = (
            unknown["redshifts"] <= hi
            if index == num_bins
            else unknown["redshifts"] < hi
        )
        keep = (unknown["redshifts"] >= lo) & upper
        sources[f"unknown_{index}"] = {
            key: value[keep] for key, value in unknown.items()
        }

    t0 = time.perf_counter()
    rows = {}
    for name, sample in sources.items():
        rows[name] = len(sample["ra"])
        _write_parquet_chunked(workdir / f"{name}.pqt", sample)
        # stride-DOWNSAMPLE copy for the consistency gate
        small = {
            key: np.ascontiguousarray(value[::DOWNSAMPLE])
            for key, value in sample.items()
        }
        _write_parquet_chunked(workdir / f"small_{name}.pqt", small)
    t_write = time.perf_counter() - t0

    return {
        "rows": rows,
        "tomographic_edges": [float(f"{q:.4f}") for q in quantiles],
        "generate_s": round(t_gen, 1),
        "parquet_write_s": round(t_write, 1),
    }


def write_setup(
    workdir: Path, path: Path, num_bins: int, *, small: bool
) -> None:
    import yaml

    prefix = "small_" if small else ""
    setup = dict(
        correlation=dict(
            scales=dict(rmin=100, rmax=1000, unit="kpc"),
            binning=dict(zmin=0.15, zmax=1.0, num_bins=11),
        ),
        inputs=dict(
            reference=dict(
                path_data=str(workdir / f"{prefix}reference.pqt"),
                path_rand=str(workdir / f"{prefix}randoms.pqt"),
                ra="ra", dec="dec", redshift="z", weight="w",
            ),
            unknown=dict(
                path_data={
                    index: str(workdir / f"{prefix}unknown_{index}.pqt")
                    for index in range(1, num_bins + 1)
                },
                ra="ra", dec="dec", redshift="z", weight="w",
            ),
            num_patches=NUM_PATCHES,
        ),
        execution=dict(max_resident_patches=MAX_RESIDENT, lazy=True),
        tasks=TASKS,
    )
    with path.open("w") as f:
        yaml.safe_dump(setup, f)


_TASK_LINE = re.compile(
    r"^(\S+ \S+) \w+ \S+ (?:running task '(\w+)'"
    r"|task '(\w+)' finished after)"
)


def parse_task_walls(log_path: Path) -> dict[str, float]:
    """Per-task wall seconds from the pipeline.log timestamp pairs."""
    started: dict[str, datetime] = {}
    walls: dict[str, float] = {}
    for line in log_path.read_text().splitlines():
        match = _TASK_LINE.match(line)
        if match is None:
            continue
        stamp = datetime.strptime(match.group(1), "%Y-%m-%d %H:%M:%S,%f")
        if match.group(2):
            started[match.group(2)] = stamp
        elif match.group(3) in started:
            name = match.group(3)
            delta = (stamp - started.pop(name)).total_seconds()
            walls[name] = round(walls.get(name, 0.0) + delta, 1)
    return walls


_BIN_LINE = re.compile(
    r"^(\S+ \S+) \w+ \S+ processing bin (\d+) / (\d+)"
)


def parse_bin_walls(log_path: Path) -> dict[str, list[float]]:
    """Per-bin marginal wall seconds inside each tomographic task, from
    the CLIENT-level ``processing bin i / N`` lines: bin i spans its own
    line to the next bin's line (or the task's ``finished`` line).
    Records whether the session tile cache amortises the shared
    reference-side blocks — bins 2..N should be materially cheaper than
    bin 1, which pays the shared sides' packing/upload."""
    walls: dict[str, list[float]] = {}
    task = None
    bin_start = None
    for line in log_path.read_text().splitlines():
        task_match = _TASK_LINE.match(line)
        if task_match is not None:
            stamp = datetime.strptime(
                task_match.group(1), "%Y-%m-%d %H:%M:%S,%f"
            )
            if task_match.group(2):
                task = task_match.group(2)
                bin_start = None
            elif task is not None and bin_start is not None:
                walls.setdefault(task, []).append(
                    round((stamp - bin_start).total_seconds(), 1)
                )
                task, bin_start = None, None
            continue
        bin_match = _BIN_LINE.match(line)
        if bin_match is not None and task is not None:
            stamp = datetime.strptime(
                bin_match.group(1), "%Y-%m-%d %H:%M:%S,%f"
            )
            if bin_start is not None:
                walls.setdefault(task, []).append(
                    round((stamp - bin_start).total_seconds(), 1)
                )
            bin_start = stamp
    return walls


def run_pipeline(
    workdir: Path, project: Path, num_bins: int, *, small: bool
) -> dict:
    """Drive the REAL CLI entry point in a subprocess and time it."""
    setup_path = workdir / ("small_setup.yml" if small else "setup.yml")
    write_setup(workdir, setup_path, num_bins=num_bins, small=small)
    shutil.rmtree(project, ignore_errors=True)

    before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.perf_counter()
    result = subprocess.run(
        [
            sys.executable, "-m", "yet_another_wizz_tpu.cli.commandline",
            str(project), str(setup_path), "--quiet",
        ],
        capture_output=True, text=True, timeout=14400,
        cwd=REPO, env=CHILD_ENV,
    )
    wall = time.perf_counter() - t0
    if result.returncode != 0:
        raise RuntimeError(
            f"pipeline failed:\n{result.stdout}\n{result.stderr}"
        )
    peak_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    record = {
        "wall_s": round(wall, 1),
        "task_walls_s": parse_task_walls(project / "pipeline.log"),
        "bin_walls_s": parse_bin_walls(project / "pipeline.log"),
    }
    if peak_rss > before:  # a smaller later child cannot update the max
        record["peak_host_rss_gb"] = round(peak_rss / 1e6, 2)
    return record


def load_estimates(project: Path, num_bins: int) -> dict:
    """Per-bin estimated n(z) (+ true-z histogram) from the project dir."""
    from yet_another_wizz_tpu.redshifts import HistData, RedshiftData

    out = {}
    for index in range(1, num_bins + 1):
        nz = RedshiftData.from_files(project / "estimate" / f"nz_est_{index}")
        hist = HistData.from_files(project / "true" / f"nz_true_{index}")
        out[index] = dict(
            nz_data=np.asarray(nz.data),
            nz_error=np.asarray(nz.error),
            hist_data=np.asarray(hist.normalised().data),
        )
    return out


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=30_000_000)
    parser.add_argument("--bins", type=int, default=4)
    parser.add_argument(
        "--small", action="store_true",
        help="300k-row smoke test of the full machinery",
    )
    parser.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "yawt_tomo_proof"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if args.small:
        set_smoke_scale()
    num_rows = 300_000 if args.small else args.rows

    record = {
        "config": "tomographic_cli_proof",
        "total_rows_requested": num_rows,
        "num_tomographic_bins": args.bins,
        "num_patches": NUM_PATCHES,
        "max_resident_patches": MAX_RESIDENT,
        "tasks": TASKS,
    }
    record["prepare"] = prepare(workdir, num_rows, args.bins)
    log(f"prepare: {record['prepare']}")

    record["pipeline"] = run_pipeline(
        workdir, workdir / "project", args.bins, small=False
    )
    log(f"pipeline: {record['pipeline']}")

    record["downsample_pipeline"] = run_pipeline(
        workdir, workdir / "project_small", args.bins, small=True
    )
    log(f"downsample pipeline: {record['downsample_pipeline']}")

    full = load_estimates(workdir / "project", args.bins)
    down = load_estimates(workdir / "project_small", args.bins)
    bins_record, chi2s = {}, []
    for index in range(1, args.bins + 1):
        f, d = full[index], down[index]
        finite = bool(np.all(np.isfinite(f["nz_data"])))
        err = np.hypot(f["nz_error"], d["nz_error"])
        # bins where the slice has no support hold noise around zero in
        # both runs; the error-aware chi2 handles them without masking
        chi2 = float(
            np.mean(((f["nz_data"] - d["nz_data"]) / err) ** 2)
        )
        # the estimate must track the slice's true redshift distribution:
        # its peak bin must carry true-z support
        peak = int(np.argmax(f["nz_data"]))
        peak_supported = bool(f["hist_data"][peak] > 0)
        chi2s.append(chi2)
        bins_record[index] = {
            "nz_finite": finite,
            "nz_data": [float(f"{v:.6g}") for v in f["nz_data"]],
            "nz_error": [float(f"{v:.6g}") for v in f["nz_error"]],
            "full_vs_downsample_chi2": round(chi2, 3),
            "peak_bin_has_true_support": peak_supported,
        }
        assert finite, f"bin {index}: non-finite n(z)"
        assert peak_supported, f"bin {index}: n(z) peak outside the slice"
    record["bins"] = bins_record
    mean_chi2 = float(np.mean(chi2s))
    record["mean_full_vs_downsample_chi2"] = round(mean_chi2, 3)
    assert mean_chi2 < 3.0, (
        f"full vs downsampled n(z) inconsistent (reduced chi2={mean_chi2:.2f})"
    )

    record["timestamp"] = time.strftime(
        "%Y-%m-%d %H:%M:%S UTC", time.gmtime()
    )
    out = args.out or (
        f"BENCH_oneshot_tomo{num_rows // 1_000_000}m.json"
        if not args.small
        else os.path.join(tempfile.gettempdir(), "tomo_proof_small.json")
    )
    Path(out).write_text(json.dumps(record, indent=1) + "\n")
    log(f"record written: {out}")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
