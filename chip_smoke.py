"""Chip smoke test: the clustering-redshift measurement on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --devices 4   # four GPUs: the sharded layouts only

Runs the main path through the public API at the benchmark's
``wsp_jackknife`` size (200k reference, 500k unknown and 1M random
points from a seed, 64 patches, 11 redshift bins):

1. prints the card (``nvidia-smi`` name and power limit), the JAX version,
   ``XLA_FLAGS``, the compile-cache directory and the native host library;
2. builds the catalogs (``patch_num`` runs k-means on the device), runs
   ``crosscorrelate`` with reference randoms, ``autocorrelate`` with RR
   (Landy-Szalay) and ``RedshiftData.from_corrfuncs`` with jackknife, and
   reports the cold and warm walls and the peak device memory;
3. runs the float64 kd-tree oracle (``backend="oracle"``) on the same data
   and checks each pair count (DD, DR, RD, RR) per scale to 1e-6 relative
   and n(z) to 1e-5, and reports the deviation per redshift bin;
4. runs the blocked out-of-core path (``max_resident_patches=8``) and
   checks it against the in-memory result to 1e-5;
5. compares the Pallas kernel with the XLA engine and prints both walls.

With ``--devices 4`` it runs only the sharded path on a four-device mesh
(``replicated``, ``columns``, ``ring`` and ``ring`` with blocks for the
cross-correlation, ``columns`` for the autocorrelation), each compared
with the one-device result.

The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed. Without a GPU the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

NUM_REFERENCE = 200_000
NUM_UNKNOWN = 500_000
NUM_RANDOMS = 1_000_000
NUM_PATCHES = 64
NUM_BINS = 11
WARM_RUNS = 3

COUNT_RTOL = 1e-6
"""Device counts against the float64 oracle, per scale (summed over bins
and patch pairs). The engine keeps ~1e-7 relative distance precision
(compensated float32 chords) and runs without the boundary audit, so a
count moves by the few pairs that lie within float32 resolution of a
bin edge. In a single small redshift bin one such pair is already more
than 1e-6 of the total, so the bins are reported, not gated."""
NZ_RTOL = 1e-5
"""n(z) against the oracle's n(z): ratios of counts, plus the float64
jackknife on top."""
BLOCKED_RTOL = 1e-5
"""Blocked out-of-core against in-memory: the same float32 engine, with
the sums taken in another order."""
KERNEL_RTOL = 1e-6
"""The Pallas kernel against the XLA engine, per redshift bin: identical
arithmetic up to FMA contraction and the order of float32 sums."""


class SmokeFailure(RuntimeError):
    """A phase produced a wrong or missing result."""


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--devices", type=int, choices=(1, 4), default=1,
        help="1: the one-card phases; 4: only the sharded path",
    )
    parser.add_argument("--seed", type=int, default=12345)
    return parser.parse_args(argv)


def card_line() -> str:
    """Name and power limit of the cards, read by a child process that
    stays off JAX."""
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip()


def require_gpu(jax) -> None:
    """Refuse to run anywhere but on a GPU: no CPU fallback."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeFailure(
            f"no GPU found: JAX runs on '{backend}'; this smoke test "
            "measures the GPU path only"
        )


def result_line(devices) -> str:
    """The final line: the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def max_rel(value, reference) -> float:
    """Largest relative deviation over the entries where the reference is
    non-zero; entries where it is zero must match exactly."""
    import numpy as np

    value = np.asarray(value, dtype=np.float64)
    reference = np.asarray(reference, dtype=np.float64)
    nonzero = reference != 0
    if np.any(value[~nonzero] != 0):
        return float("inf")
    if not np.any(nonzero):
        return 0.0
    return float(np.max(
        np.abs(value[nonzero] - reference[nonzero]) / np.abs(reference[nonzero])
    ))


def bin_totals(corrfuncs) -> dict:
    """Each pair count of each correlation function, summed per redshift
    bin over all patch pairs."""
    totals = {}
    for i, corrfunc in enumerate(corrfuncs):
        for name in ("dd", "dr", "rd", "rr"):
            counts = getattr(corrfunc, name, None)
            if counts is not None:
                totals[f"{i}.{name}"] = counts.counts.counts.sum(axis=(1, 2))
    return totals


def compare_counts(got, expected, rtol: float, what: str) -> float:
    """Gate the per-scale totals at ``rtol``; print the per-bin deviation
    of each count. Returns the worst per-scale deviation."""
    got, expected = bin_totals(got), bin_totals(expected)
    check(got.keys() == expected.keys(), f"{what}: different counts present")
    per_scale = {
        key: max_rel(got[key].sum(), expected[key].sum()) for key in expected
    }
    per_bin = {
        key: max_rel(got[key], expected[key]) for key in expected
    }
    print(f"  {what}, per scale: "
          + ", ".join(f"{k} {v:.3e}" for k, v in per_scale.items()))
    print(f"  {what}, worst bin: "
          + ", ".join(f"{k} {v:.3e}" for k, v in per_bin.items()))
    worst = max(per_scale.values())
    check(worst <= rtol, f"{what}: counts deviate by {worst:.3e} > {rtol}")
    return worst


def peak_device_bytes(device) -> int:
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
    check(peak is not None, "memory_stats() reports no peak_bytes_in_use")
    return peak


def timed(fn):
    """Wall of ``fn()``; the measurement returns host arrays, so the
    device work has finished when it returns."""
    start = time.perf_counter()
    result = fn()
    return time.perf_counter() - start, result


def make_catalogs(seed: int):
    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=NUM_REFERENCE, num_unknown=NUM_UNKNOWN,
        num_randoms=NUM_RANDOMS, seed=seed,
    )
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
    return reference, unknown, randoms


def measure(config, reference, unknown, randoms, **kwargs):
    """The main path: w_sp with reference randoms, w_ss with RR, and the
    jackknife n(z)."""
    from yet_another_wizz_tpu import RedshiftData
    from yet_another_wizz_tpu.correlation.measurements import (
        autocorrelate,
        crosscorrelate,
    )

    (w_sp,) = crosscorrelate(
        config, reference, unknown, ref_rand=randoms, **kwargs
    )
    (w_ss,) = autocorrelate(config, reference, randoms, **kwargs)
    nz = RedshiftData.from_corrfuncs(w_sp, w_ss)
    return w_sp, w_ss, nz


def run_one_card(config, catalogs) -> None:
    import jax
    import numpy as np

    from yet_another_wizz_tpu.utils import devicemem

    device = jax.devices()[0]

    # phase 2: the main path, cold and warm
    devicemem.reset_peak()
    cold, (w_sp, w_ss, nz) = timed(lambda: measure(config, *catalogs))
    warm = [timed(lambda: measure(config, *catalogs))[0]
            for _ in range(WARM_RUNS)]
    peak = peak_device_bytes(device)
    check(
        nz.data.shape == (NUM_BINS,) and np.all(np.isfinite(nz.data)),
        f"n(z) is not {NUM_BINS} finite values: {nz.data}",
    )
    print(f"main path: cold {cold:.4f} s, warm median "
          f"{float(np.median(warm)):.4f} s (walls {warm})")
    print(f"peak device memory: {peak} B (memory_stats), "
          f"{devicemem.snapshot()['peak_bytes']} B (devicemem accounting)")

    # phase 3: the float64 oracle on the same data
    start = time.perf_counter()
    o_sp, o_ss, o_nz = measure(config, *catalogs, backend="oracle")
    oracle_s = time.perf_counter() - start
    x_sp, x_ss, _ = measure(config, *catalogs, backend="xla")
    compare_counts(
        [x_sp, x_ss], [o_sp, o_ss], COUNT_RTOL, "xla engine vs oracle"
    )
    counts_dev = compare_counts(
        [w_sp, w_ss], [o_sp, o_ss], COUNT_RTOL, "device vs float64 oracle"
    )
    nz_dev = max_rel(nz.data, o_nz.data)
    check(nz_dev <= NZ_RTOL, f"n(z) deviates from the oracle by {nz_dev:.3e}")
    print(f"float64 oracle ({oracle_s:.1f} s): counts max rel "
          f"{counts_dev:.3e} (limit {COUNT_RTOL}), n(z) max rel "
          f"{nz_dev:.3e} (limit {NZ_RTOL})")

    # phase 4: blocked out-of-core against in-memory
    b_sp, b_ss, b_nz = measure(config, *catalogs, max_resident_patches=8)
    blocked_dev = compare_counts(
        [b_sp, b_ss], [w_sp, w_ss], BLOCKED_RTOL, "blocked vs in-memory"
    )
    blocked_nz = max_rel(b_nz.data, nz.data)
    check(blocked_nz <= BLOCKED_RTOL,
          f"blocked n(z) deviates by {blocked_nz:.3e}")
    print(f"blocked (max_resident_patches=8) vs in-memory: counts max rel "
          f"{blocked_dev:.3e}, n(z) max rel {blocked_nz:.3e} "
          f"(limit {BLOCKED_RTOL})")

    # phase 5: the Pallas kernel against the XLA engine
    results, walls = {}, {"pallas": [], "xla": []}
    for backend in walls:
        results[backend] = measure(config, *catalogs, backend=backend)
    for turn in range(WARM_RUNS):
        for backend in (("pallas", "xla") if turn % 2 else ("xla", "pallas")):
            walls[backend].append(timed(
                lambda: measure(config, *catalogs, backend=backend)
            )[0])
    kernel_dev = compare_counts(
        results["pallas"][:2], results["xla"][:2], KERNEL_RTOL,
        "pallas vs xla",
    )
    print(f"pallas vs xla: counts max rel {kernel_dev:.3e} (limit "
          f"{KERNEL_RTOL}); warm median pallas "
          f"{float(np.median(walls['pallas'])):.4f} s, xla "
          f"{float(np.median(walls['xla'])):.4f} s")


def run_sharded(config, catalogs, num_devices: int) -> None:
    import jax

    from yet_another_wizz_tpu.correlation.measurements import (
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu.parallel import default_mesh

    check(len(jax.devices()) >= num_devices,
          f"need {num_devices} devices, found {len(jax.devices())}")
    mesh = default_mesh(num_devices)
    reference, unknown, randoms = catalogs

    def cross(**kwargs):
        return crosscorrelate(
            config, reference, unknown, ref_rand=randoms, **kwargs
        )

    def auto(**kwargs):
        return autocorrelate(config, reference, randoms, **kwargs)

    single_cross = cross(mesh="single")
    single_auto = auto(mesh="single")
    cases = [
        ("cross replicated", cross, {"data_sharding": "replicated"},
         single_cross),
        ("cross columns", cross, {"data_sharding": "columns"}, single_cross),
        ("cross ring", cross, {"data_sharding": "ring"}, single_cross),
        ("cross ring blocked", cross,
         {"data_sharding": "ring", "max_resident_patches": 8}, single_cross),
        ("auto columns", auto, {"data_sharding": "columns"}, single_auto),
    ]
    for name, fn, kwargs, expected in cases:
        fn(mesh=mesh, **kwargs)  # compile
        wall, got = timed(lambda: fn(mesh=mesh, **kwargs))
        dev = compare_counts(got, expected, BLOCKED_RTOL, name)
        print(f"{name} on {num_devices} devices: counts max rel {dev:.3e} "
              f"vs one device (limit {BLOCKED_RTOL}), warm {wall:.4f} s")


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import jax

        from yet_another_wizz_tpu import Configuration, _native
        from yet_another_wizz_tpu.utils.compile_cache import (
            enable_persistent_compile_cache,
        )
    except ImportError as err:
        print(f"chip_smoke: cannot import the program: {err}",
              file=sys.stderr)
        return 2
    try:
        require_gpu(jax)
        cache = enable_persistent_compile_cache()
        devices = jax.devices()
        print(card_line())
        print(f"device_kind: {devices[0].device_kind} x {len(devices)}")
        print(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
        print(f"compile cache: {cache}")
        print(f"native host library: {_native.NATIVE_ENABLED}")
        check(_native.NATIVE_ENABLED,
              "the native host library did not build from tilepack.cpp")

        config = Configuration.create(
            rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0,
            num_bins=NUM_BINS,
        )
        start = time.perf_counter()
        catalogs = make_catalogs(args.seed)
        print(f"catalogs (mock data and k-means patches): "
              f"{time.perf_counter() - start:.2f} s")
        if args.devices > 1:
            run_sharded(config, catalogs, args.devices)
            devices = devices[: args.devices]
        else:
            run_one_card(config, catalogs)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
