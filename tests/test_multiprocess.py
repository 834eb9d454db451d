"""Two-process execution tests: emulate a multi-host job with two CPU
processes of 2 virtual devices each, joined via ``jax.distributed`` (gloo
collectives stand in for the interconnect of real hosts).

Covers the multi-host contract of SURVEY.md section 2.2 (the reference
scales out over MPI ranks, /root/reference/src/yaw/utils/parallel.py): the
sharded engine produces identical counts across process boundaries, and
all file I/O follows the root-writes/barrier discipline.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).parent / "multiprocess_worker.py"
REPO_ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# XLA's gloo adapter hard-codes a 30 s key-exchange deadline when a new
# cross-process communicator is established. On a single-core CI host the
# two workers' XLA compilations serialise, which can skew their arrival at
# a collective past that deadline — an infrastructure timeout, not a
# correctness failure. A shared persistent compile cache plus one retry
# (warm cache => near-zero skew) makes the tests deterministic.
_GLOO_TIMEOUT = "Gloo context initialization failed"


def _run_pair_once(
    mode: str,
    workdir: Path,
    cache_dir: Path,
    timeout: float,
    num_procs: int = 2,
    devices_per_proc: int = 2,
) -> list:
    port = _free_port()
    procs = []
    for rank in range(num_procs):
        env = os.environ.copy()
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                "--xla_force_host_platform_device_count="
                f"{devices_per_proc}"
            ),
            YAWT_COORDINATOR=f"localhost:{port}",
            YAWT_NUM_PROCESSES=str(num_procs),
            YAWT_PROCESS_ID=str(rank),
            JAX_COMPILATION_CACHE_DIR=str(cache_dir),
            JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
            JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(WORKER), mode, str(workdir)],
                env=env,
                cwd=REPO_ROOT,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    results = []
    try:
        for proc in procs:
            try:
                out, _ = proc.communicate(timeout=timeout)
                results.append((proc.returncode, out))
            except subprocess.TimeoutExpired:
                # a hung pair counts as a failed attempt (retried once by
                # the caller) instead of erroring the test outright
                proc.kill()
                out, _ = proc.communicate()
                results.append((-1, (out or "") + "\n<pair timed out>"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return results


def _launch_pair(
    mode: str,
    workdir: Path,
    timeout: float = 300.0,
    num_procs: int = 2,
    devices_per_proc: int = 2,
) -> None:
    """Run a worker group to completion, failing with their output."""
    import shutil

    import tempfile

    # one persistent compile cache across ALL multi-process tests: a cold
    # per-test cache is what skews the workers' arrival at their first
    # collective past gloo's fixed 30 s key-exchange deadline
    cache_dir = Path(tempfile.gettempdir()) / "yawt_mp_jax_cache"
    for attempt in range(2):
        results = _run_pair_once(
            mode, workdir, cache_dir, timeout,
            num_procs=num_procs, devices_per_proc=devices_per_proc,
        )
        if all(rc == 0 for rc, _ in results):
            return
        outputs = "".join(out for _, out in results)
        # the ONLY tolerated infrastructure flake: on a loaded single-core
        # CI host the workers' arrival at their first collective can skew
        # past gloo's fixed 30 s key-exchange deadline, which surfaces as
        # the literal "Gloo context initialization failed" message (or as
        # an outright hang that _run_pair_once kills). Any other failure
        # is a real bug and must fail immediately — a blanket retry would
        # hand intermittent collective regressions (ordering, deadlock on
        # error) one free pass per run.
        infrastructure = (
            _GLOO_TIMEOUT in outputs or "<pair timed out>" in outputs
        )
        if attempt == 0 and infrastructure:
            import warnings

            warnings.warn(
                f"worker pair '{mode}' hit the gloo key-exchange "
                "deadline (retrying once with the warm compile cache)"
            )
            shutil.rmtree(workdir / "project_mp", ignore_errors=True)
            shutil.rmtree(workdir / "cache_mp", ignore_errors=True)
            shutil.rmtree(workdir / "project_pod4", ignore_errors=True)
            shutil.rmtree(workdir / "cache_pod4", ignore_errors=True)
            (workdir / "payload.hdf").unlink(missing_ok=True)
            continue
        for rank, (rc, out) in enumerate(results):
            assert rc == 0, f"worker {rank} failed (rc={rc}):\n{out}"
    raise AssertionError(f"worker pair failed twice:\n{outputs}")


def test_two_process_engine(tmp_path):
    """Sharded counts across two processes match the single-process result
    for every data layout; broadcast and root-guarded writes behave."""
    sys.path.insert(0, str(REPO_ROOT))
    from __graft_entry__ import _tiny_problem

    from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles

    ts1, ts2, pairs, chord2 = _tiny_problem()
    expected = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    np.save(tmp_path / "expected.npy", expected)

    _launch_pair("engine", tmp_path)

    # exactly one writer: the guarded to_file produced root's payload
    import h5py

    with h5py.File(tmp_path / "payload.hdf", "r") as f:
        assert int(f["value"][()]) == 0


def test_two_process_root_error_propagates(tmp_path):
    """A root-only exception (stale lock file) is re-raised on every
    process via the collective outcome broadcast; previously the non-root
    rank deadlocked at the post-acquire barrier."""
    (tmp_path / "stale.lock").write_text("123:crashed")
    _launch_pair("root_error", tmp_path, timeout=180.0)


@pytest.mark.slow
@pytest.mark.parametrize(
    "execution", [None, dict(max_resident_patches=2)],
    ids=["in-memory", "blocked"],
)
def test_two_process_pipeline(tmp_path, execution):
    """The full CLI pipeline, run collectively by two processes, produces
    the same redshift estimate as a single-process run — including the
    blocked out-of-core mode (lazy catalogs + session tile cache +
    per-block mesh-sharded counts) when ``execution:`` asks for it."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml

    from yet_another_wizz_tpu.cli.pipeline import run_setup
    from yet_another_wizz_tpu.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=1500, num_unknown=2500, num_randoms=5000, seed=7
    )
    paths = {}
    for name, sample in mock.items():
        table = pa.table(
            dict(
                ra=np.rad2deg(sample["ra"]),
                dec=np.rad2deg(sample["dec"]),
                z=sample["redshifts"],
            )
        )
        paths[name] = str(tmp_path / f"{name}.pqt")
        pq.write_table(table, paths[name])

    setup = dict(
        correlation=dict(
            scales=dict(rmin=500, rmax=3000, unit="kpc"),
            binning=dict(zmin=0.15, zmax=1.0, num_bins=3),
        ),
        inputs=dict(
            reference=dict(
                path_data=paths["reference"],
                path_rand=paths["randoms"],
                ra="ra", dec="dec", redshift="z",
            ),
            unknown=dict(
                path_data={1: paths["unknown"]},
                path_rand={1: paths["randoms"]},
                ra="ra", dec="dec", redshift="z",
            ),
            num_patches=4,
        ),
        tasks=["auto_ref", "cross_corr", "estimate", "hist"],
    )
    if execution is not None:
        setup["execution"] = execution
    with (tmp_path / "setup.yml").open("w") as f:
        yaml.safe_dump(setup, f)

    # single-process reference run
    run_setup(tmp_path / "project_sp", tmp_path / "setup.yml", quiet=True)

    _launch_pair("pipeline", tmp_path, timeout=420.0)

    # the lock must be released and all products present exactly once
    assert not (tmp_path / "project_mp" / ".tasklock").exists()
    for product in ("estimate/nz_est_1", "estimate/cross_1"):
        sp = np.loadtxt(tmp_path / f"project_sp/{product}.dat")
        mp = np.loadtxt(tmp_path / f"project_mp/{product}.dat")
        # engines differ only in device count / summation order
        np.testing.assert_allclose(mp, sp, rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_four_process_pod(tmp_path):
    """A 4-process virtual pod (1 device each): collective ingestion,
    sharded counts in every layout and the CLI pipeline must reproduce
    the single-process results. Four distinct ranks catch owner/rank
    arithmetic bugs (e.g. patch ownership ``pid % N``, shard-owner
    indexing) that 2-process runs cannot distinguish from parity
    coincidences."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml

    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.cli.pipeline import run_setup
    from yet_another_wizz_tpu.coordinates import AngularCoordinates
    from yet_another_wizz_tpu.examples import generate_mock_data
    from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles

    sys.path.insert(0, str(REPO_ROOT))
    from __graft_entry__ import _tiny_problem

    # engine expectation
    ts1, ts2, pairs, chord2 = _tiny_problem()
    expected = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    np.save(tmp_path / "expected.npy", expected)

    # ingestion input + single-process reference cache (7 patches: not a
    # multiple of 4 ranks, so ownership wraps unevenly)
    mock = generate_mock_data(
        num_reference=4000, num_unknown=2500, num_randoms=5000, seed=23
    )
    paths = {}
    for name, sample in mock.items():
        table = pa.table(
            dict(
                ra=np.rad2deg(sample["ra"]),
                dec=np.rad2deg(sample["dec"]),
                z=sample["redshifts"],
            )
        )
        paths[name] = str(tmp_path / f"{name}.pqt")
        pq.write_table(table, paths[name])
    (tmp_path / "ingest.pqt").write_bytes(
        Path(paths["reference"]).read_bytes()
    )
    probe = Catalog.from_arrays(
        mock["reference"]["ra"], mock["reference"]["dec"],
        degrees=False, patch_num=7,
    )
    centers = probe.get_centers().data
    np.save(tmp_path / "centers.npy", centers)
    Catalog.from_file(
        tmp_path / "cache_sp",
        tmp_path / "ingest.pqt",
        ra_name="ra", dec_name="dec", redshift_name="z",
        patch_centers=AngularCoordinates(centers),
        degrees=True, streaming=True, chunksize=1000,
    )

    # pipeline setup + single-process reference run
    setup = dict(
        correlation=dict(
            scales=dict(rmin=500, rmax=3000, unit="kpc"),
            binning=dict(zmin=0.15, zmax=1.0, num_bins=3),
        ),
        inputs=dict(
            reference=dict(
                path_data=paths["reference"],
                path_rand=paths["randoms"],
                ra="ra", dec="dec", redshift="z",
            ),
            unknown=dict(
                path_data={1: paths["unknown"]},
                path_rand={1: paths["randoms"]},
                ra="ra", dec="dec", redshift="z",
            ),
            num_patches=4,
        ),
        tasks=["cross_corr", "estimate"],
    )
    with (tmp_path / "setup.yml").open("w") as f:
        yaml.safe_dump(setup, f)
    run_setup(tmp_path / "project_sp", tmp_path / "setup.yml", quiet=True)

    _launch_pair(
        "pod4", tmp_path, timeout=600.0, num_procs=4, devices_per_proc=1
    )

    assert not (tmp_path / "project_pod4" / ".tasklock").exists()
    sp = np.loadtxt(tmp_path / "project_sp/estimate/nz_est_1.dat")
    pod = np.loadtxt(tmp_path / "project_pod4/estimate/nz_est_1.dat")
    np.testing.assert_allclose(pod, sp, rtol=1e-4, atol=1e-6)


def _free_port_in_ompi_range() -> int:
    """A bindable port in the range jax's OmpiCluster derives coordinator
    ports from (the top 2^12 of the ephemeral range)."""
    for port in range(61440, 65536):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in the OmpiCluster range")


def test_ompi_launcher_autodetect(tmp_path):
    """Workers launched with ONLY the Open MPI environment (the variables
    ``mpirun`` exports; no YAWT_* wiring) form a cluster through
    ``initialize()``'s launcher auto-detection — the ergonomic parity
    with the reference under ``mpirun -n 2``."""
    import tempfile

    # OmpiCluster derives the coordinator as <launcher ip>:<f(job id)>
    # with f(job) = job // 2**12 % 2**12 + 61440; invert it so the
    # derived port is one we verified to be free
    port = _free_port_in_ompi_range()
    job_id = (port - 61440) * 2**12
    orte_uri = f"{job_id}.0;tcp://127.0.0.1,10.0.0.1:11111"

    cache_dir = Path(tempfile.gettempdir()) / "yawt_mp_jax_cache"
    for attempt in range(2):
        procs = []
        for rank in range(2):
            env = {
                k: v
                for k, v in os.environ.items()
                if not k.startswith("YAWT_")
            }
            env.update(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2",
                OMPI_MCA_orte_hnp_uri=orte_uri,
                OMPI_COMM_WORLD_SIZE="2",
                OMPI_COMM_WORLD_RANK=str(rank),
                OMPI_COMM_WORLD_LOCAL_RANK=str(rank),
                JAX_COMPILATION_CACHE_DIR=str(cache_dir),
                JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
                JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
            )
            procs.append(
                subprocess.Popen(
                    [sys.executable, str(WORKER), "ompi", str(tmp_path)],
                    env=env,
                    cwd=REPO_ROOT,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        results = []
        try:
            for proc in procs:
                try:
                    out, _ = proc.communicate(timeout=240.0)
                    results.append((proc.returncode, out))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                    results.append((-1, (out or "") + "\n<pair timed out>"))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        if all(rc == 0 for rc, _ in results):
            assert all("OMPI OK" in out for _, out in results)
            return
        outputs = "".join(out for _, out in results)
        infrastructure = (
            _GLOO_TIMEOUT in outputs or "<pair timed out>" in outputs
        )
        if attempt == 0 and infrastructure:
            continue
        for rank, (rc, out) in enumerate(results):
            assert rc == 0, f"ompi worker {rank} failed (rc={rc}):\n{out}"


def test_ompi_launcher_unresolvable_raises(tmp_path):
    """World size exported by a launcher but no derivable coordinator:
    initialize() must raise the actionable error (pointing at the YAWT_*
    variables) instead of silently latching single-host mode."""
    env = {
        k: v for k, v in os.environ.items() if not k.startswith("YAWT_")
    }
    env.update(
        JAX_PLATFORMS="cpu",
        OMPI_COMM_WORLD_SIZE="2",
        OMPI_COMM_WORLD_RANK="0",
    )
    env.pop("OMPI_MCA_orte_hnp_uri", None)
    result = subprocess.run(
        [sys.executable, str(WORKER), "ompi_error", str(tmp_path)],
        env=env, cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120.0,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert "OMPI ERROR OK" in result.stdout


def test_two_process_collective_ingest(tmp_path):
    """Collective streaming ingestion: root reads and assigns, both ranks
    write the patches they own; the shared cache must equal a
    single-process streaming ingest byte for byte."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.coordinates import AngularCoordinates
    from yet_another_wizz_tpu.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=4000, num_unknown=10, num_randoms=10, seed=21
    )
    sample = mock["reference"]
    pq.write_table(
        pa.table(
            dict(
                ra=np.rad2deg(sample["ra"]),
                dec=np.rad2deg(sample["dec"]),
                z=sample["redshifts"],
            )
        ),
        str(tmp_path / "ingest.pqt"),
    )
    probe = Catalog.from_arrays(
        sample["ra"], sample["dec"], degrees=False, patch_num=5
    )
    centers = probe.get_centers().data  # (N, 2) radian
    np.save(tmp_path / "centers.npy", centers)

    # single-process streaming reference ingest
    single = Catalog.from_file(
        tmp_path / "cache_sp",
        tmp_path / "ingest.pqt",
        ra_name="ra",
        dec_name="dec",
        redshift_name="z",
        patch_centers=AngularCoordinates(centers),
        degrees=True,
        streaming=True,
        chunksize=1000,
    )
    np.save(
        tmp_path / "expected_records.npy",
        np.asarray(single.get_num_records()),
    )

    _launch_pair("ingest", tmp_path, timeout=300.0)
