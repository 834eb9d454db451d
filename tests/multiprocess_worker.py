"""Worker entry point for the two-process (multi-host emulation) tests.

Launched as ``python multiprocess_worker.py <mode> <workdir>`` with the
``YAWT_COORDINATOR`` / ``YAWT_NUM_PROCESSES`` / ``YAWT_PROCESS_ID``
environment variables set per process (the same launch contract as a real
pod job). Each process brings up 2 virtual CPU devices, so two workers
form a 4-device global mesh across process boundaries — cross-process
collectives run over gloo exactly where a multi-host job would use NCCL.

Not collected by pytest (no ``test_`` prefix); driven by
``tests/test_multiprocess.py``.
"""

import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

os.environ["JAX_PLATFORMS"] = "cpu"
# the launcher sets the per-process device count; standalone runs get 2
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=2"
)

sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from yet_another_wizz_tpu import parallel  # noqa: E402


def check_cluster():
    parallel.initialize()
    num_procs = int(os.environ["YAWT_NUM_PROCESSES"])
    local = jax.local_device_count()
    assert parallel.num_processes() == num_procs, parallel.num_processes()
    assert jax.device_count() == num_procs * local, jax.device_count()


def run_engine(workdir: Path) -> None:
    """Sharded pair counts on the global 4-device mesh, plus the host-side
    coordination helpers (broadcast, root-guarded writes)."""
    from __graft_entry__ import _tiny_problem

    from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu.utils.abc import HdfSerializable

    check_cluster()
    rank = parallel.process_index()

    ts1, ts2, pairs, chord2 = _tiny_problem()
    expected = np.load(workdir / "expected.npy")

    mesh = parallel.default_mesh()
    assert mesh.devices.size == 4
    for data_sharding in ("replicated", "columns", "ring"):
        result = parallel.count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=data_sharding
        )
        np.testing.assert_allclose(
            result, expected, rtol=1e-5, atol=1e-2,
            err_msg=f"{data_sharding} (rank {rank})",
        )

    # pod jobs default to the global mesh without an explicit mesh argument
    result = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    np.testing.assert_allclose(
        result, expected, rtol=1e-5, atol=1e-2, err_msg="auto-mesh"
    )

    # host-side value broadcast: every process must see root's payload
    value = parallel.broadcast({"rank": rank, "data": np.arange(5)})
    assert value["rank"] == 0, value
    np.testing.assert_array_equal(value["data"], np.arange(5))

    class Payload(HdfSerializable):
        def __init__(self, value: int) -> None:
            self.value = value

        @classmethod
        def from_hdf(cls, source):
            return cls(int(source["value"][()]))

        def to_hdf(self, dest) -> None:
            dest.create_dataset("value", data=self.value)

    # root-guarded writes: both processes call to_file with different
    # payloads; the file must contain root's (exactly one writer)
    target = workdir / "payload.hdf"
    Payload(rank).to_file(target)
    assert Payload.from_file(target).value == 0

    parallel.barrier("engine_done")
    print(f"ENGINE OK rank={rank}")


def run_pipeline(workdir: Path) -> None:
    """The full CLI pipeline executed collectively by both processes."""
    from yet_another_wizz_tpu.cli.pipeline import run_setup

    check_cluster()
    # create the gloo context NOW, while the processes are still in sync:
    # the pipeline's first natural collective comes after ingestion, by
    # which time single-core contention can skew the two workers past
    # gloo's fixed 30 s key-exchange deadline
    parallel.barrier("pipeline_warmup")
    run_setup(workdir / "project_mp", workdir / "setup.yml", quiet=True)
    parallel.barrier("pipeline_done")
    print(f"PIPELINE OK rank={parallel.process_index()}")


def run_ingest(workdir: Path) -> None:
    """Collective streaming ingestion: root reads + assigns, both ranks
    write their owned patches; the resulting cache must be byte-identical
    to a single-process streaming ingest of the same file."""
    from yet_another_wizz_tpu import Catalog

    check_cluster()
    rank = parallel.process_index()

    catalog = Catalog.from_file(
        workdir / "cache_mp",
        workdir / "ingest.pqt",
        ra_name="ra",
        dec_name="dec",
        redshift_name="z",
        patch_centers=np.load(workdir / "centers.npy"),
        degrees=True,
        streaming=True,
        chunksize=1000,  # several chunks -> several collective rounds
    )
    num_patches = catalog.num_patches
    expected_records = np.load(workdir / "expected_records.npy")
    np.testing.assert_array_equal(catalog.get_num_records(), expected_records)

    # byte parity with the single-process streaming cache
    for pid in range(num_patches):
        mp = (workdir / "cache_mp" / f"patch_{pid}" / "data.bin").read_bytes()
        sp = (workdir / "cache_sp" / f"patch_{pid}" / "data.bin").read_bytes()
        assert mp == sp, f"patch {pid} differs (rank {rank})"

    parallel.barrier("ingest_done")
    print(f"INGEST OK rank={rank}")


def run_pod4(workdir: Path) -> None:
    """Four-process virtual pod: collective ingestion, sharded engine
    counts in every layout, and the CLI pipeline — exercising rank
    arithmetic (patch ownership pid % N, shard owner indexing) that a
    2-process job cannot distinguish from parity tricks."""
    from yet_another_wizz_tpu import Catalog
    from yet_another_wizz_tpu.cli.pipeline import run_setup
    from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles

    check_cluster()
    rank = parallel.process_index()
    assert parallel.num_processes() == 4

    # collective streaming ingestion: root reads/assigns, all four ranks
    # write the patches they own (pid % 4) — byte parity with the
    # single-process cache written by the test
    catalog = Catalog.from_file(
        workdir / "cache_pod4",
        workdir / "ingest.pqt",
        ra_name="ra",
        dec_name="dec",
        redshift_name="z",
        patch_centers=np.load(workdir / "centers.npy"),
        degrees=True,
        streaming=True,
        chunksize=1000,
    )
    for pid in range(catalog.num_patches):
        mp = (workdir / "cache_pod4" / f"patch_{pid}" / "data.bin").read_bytes()
        sp = (workdir / "cache_sp" / f"patch_{pid}" / "data.bin").read_bytes()
        assert mp == sp, f"patch {pid} differs (rank {rank})"

    # sharded engine counts on the global 4-device mesh (1 device/proc):
    # every layout's owner arithmetic meets 4 distinct process ranks
    from __graft_entry__ import _tiny_problem

    ts1, ts2, pairs, chord2 = _tiny_problem()
    expected = np.load(workdir / "expected.npy")
    mesh = parallel.default_mesh()
    assert mesh.devices.size == 4
    for data_sharding in ("replicated", "columns", "ring"):
        result = parallel.count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=data_sharding
        )
        np.testing.assert_allclose(
            result, expected, rtol=1e-5, atol=1e-2,
            err_msg=f"{data_sharding} (rank {rank}/4)",
        )
    result = count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla")
    np.testing.assert_allclose(
        result, expected, rtol=1e-5, atol=1e-2, err_msg="auto-mesh (pod4)"
    )

    # the CLI pipeline, run collectively by all four processes
    parallel.barrier("pod4_pipeline_warmup")
    run_setup(workdir / "project_pod4", workdir / "setup.yml", quiet=True)

    parallel.barrier("pod4_done")
    print(f"POD4 OK rank={rank}")


def run_ompi(workdir: Path) -> None:
    """Launched with ONLY the Open MPI launcher environment (no YAWT_*
    variables): ``initialize()`` must auto-detect the cluster through
    jax's launcher detection, mirroring the reference picking up
    ``mpirun`` through mpi4py
    (/root/reference/src/yaw/utils/parallel.py:88-99)."""
    assert "YAWT_COORDINATOR" not in os.environ
    assert "YAWT_NUM_PROCESSES" not in os.environ
    parallel.initialize()

    size = int(os.environ["OMPI_COMM_WORLD_SIZE"])
    rank = int(os.environ["OMPI_COMM_WORLD_RANK"])
    assert parallel.num_processes() == size, parallel.num_processes()
    assert parallel.process_index() == rank, parallel.process_index()

    value = parallel.broadcast({"rank": parallel.process_index()})
    assert value == {"rank": 0}, value
    parallel.barrier("ompi_done")
    print(f"OMPI OK rank={rank}")


def run_ompi_error(workdir: Path) -> None:
    """A multi-rank launcher environment whose cluster configuration jax
    cannot derive (world size exported, no coordinator discoverable) must
    fail with the actionable error, not latch single-host mode."""
    os.environ["OMPI_COMM_WORLD_SIZE"] = "2"
    os.environ.pop("OMPI_MCA_orte_hnp_uri", None)
    try:
        parallel.initialize()
    except RuntimeError as err:
        assert "YAWT_COORDINATOR" in str(err), err
        print("OMPI ERROR OK")
        return
    raise AssertionError("initialize() silently ignored the launcher env")


def run_root_error(workdir: Path) -> None:
    """Root-side failures must propagate to every process (collective
    re-raise) instead of deadlocking non-root ranks at a barrier."""
    from yet_another_wizz_tpu.cli.pipeline import LockFile

    check_cluster()
    rank = parallel.process_index()

    # outcome propagation: non-root receives root's return value
    value = parallel.run_on_root(lambda: {"rank": rank})
    assert value == {"rank": 0}, value

    lock = LockFile(workdir / "stale.lock")
    try:
        lock.acquire("test")
    except RuntimeError as err:
        assert "remove the lock file" in str(err), err
        parallel.barrier("root_error_done")
        print(f"ROOT ERROR PROPAGATED rank={rank}")
        return
    raise AssertionError(f"rank {rank}: stale lock not detected")


def main() -> None:
    mode, workdir = sys.argv[1], Path(sys.argv[2])
    # hang diagnosis: `kill -USR1 <pid>` dumps all thread stacks to a file
    import faulthandler
    import signal

    rank = os.environ.get(
        "YAWT_PROCESS_ID", os.environ.get("OMPI_COMM_WORLD_RANK", "x")
    )
    stack_log = open(workdir / f"stacks_{mode}_{rank}.log", "w")
    faulthandler.register(signal.SIGUSR1, file=stack_log, all_threads=True)
    if mode == "engine":
        run_engine(workdir)
    elif mode == "pipeline":
        run_pipeline(workdir)
    elif mode == "ingest":
        run_ingest(workdir)
    elif mode == "pod4":
        run_pod4(workdir)
    elif mode == "ompi":
        run_ompi(workdir)
    elif mode == "ompi_error":
        run_ompi_error(workdir)
    elif mode == "root_error":
        run_root_error(workdir)
    else:
        raise SystemExit(f"unknown mode: {mode}")


if __name__ == "__main__":
    main()
