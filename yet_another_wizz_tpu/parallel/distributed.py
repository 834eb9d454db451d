"""Multi-host (pod) execution helpers.

Capability parity with the reference's MPI communication layer
(/root/reference/src/yaw/utils/parallel.py:38-484): process-role helpers
(`on_root`), collective broadcast of host-side values, and a barrier —
expressed over jax.distributed instead of mpi4py. On a single process all
helpers degrade to no-ops, mirroring the reference's ``MockComm``.

The data-plane collectives (``psum`` over the tile-pair grid) live in
:mod:`yet_another_wizz_tpu.parallel.sharded`; this module only covers
host-side coordination (configuration exchange, root-only I/O).
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from collections.abc import Callable
    from typing import Any

__all__ = [
    "barrier",
    "broadcast",
    "broadcasted",
    "initialize",
    "num_processes",
    "on_root",
    "picklable_exception",
    "process_index",
    "run_on_root",
]

logger = logging.getLogger(__name__)

_initialized = False
_multiprocess = False  # set only when a jax.distributed cluster was started

# environment fallbacks for manual pod launches (one variable set per
# process, e.g. by a job scheduler wrapper); jax.distributed additionally
# auto-detects Slurm/GKE cluster environments when these are unset
ENV_COORDINATOR = "YAWT_COORDINATOR"
ENV_NUM_PROCESSES = "YAWT_NUM_PROCESSES"
ENV_PROCESS_ID = "YAWT_PROCESS_ID"

# world-size variables exported by common multi-process launchers, in
# detection order: Open MPI / mpiexec (ORTE), MPICH-style PMI, Slurm srun.
# For Slurm this must be the per-STEP task count (srun exports it for the
# tasks it spawns) — NOT SLURM_NTASKS, which sbatch also exports into the
# batch step itself, where exactly one process exists regardless of
# --ntasks; keying on it would send a plain `python script.py` inside an
# sbatch allocation into cluster init, blocking for peers that never come.
_LAUNCHER_WORLD_SIZE_VARS = (
    "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE",
    "SLURM_STEP_NUM_TASKS",
)


def _launched_world_size() -> int | None:
    """World size advertised by an MPI-style launcher environment, or
    None when not running under one. The analogue of the reference
    answering ``mpirun -n 4`` by asking mpi4py for its world size
    (/root/reference/src/yaw/utils/parallel.py:88-99)."""
    for var in _LAUNCHER_WORLD_SIZE_VARS:
        value = os.environ.get(var)
        if value is not None:
            try:
                return int(value)
            except ValueError:  # malformed launcher env; ignore it
                return None
    return None


def initialize(
    coordinator_address: str | None = None,
    process_count: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialise jax.distributed for a multi-host pod (no-op when already
    initialised or when running single-host with no coordinator).

    Arguments default to the ``YAWT_COORDINATOR`` / ``YAWT_NUM_PROCESSES``
    / ``YAWT_PROCESS_ID`` environment variables, so launchers only need to
    export those before starting one process per host. When neither is
    given but the process was started by an MPI-style launcher (Open
    MPI/``mpiexec``, Slurm ``srun``) with more than one rank, the cluster
    configuration is auto-detected from the launcher environment — the
    analogue of the reference running under ``mpirun``
    (/root/reference/src/yaw/utils/parallel.py:75-101).
    """
    global _initialized, _multiprocess
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR
    )
    if process_count is None and ENV_NUM_PROCESSES in os.environ:
        process_count = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])

    if _initialized:
        if not _multiprocess and (
            coordinator_address is not None
            or process_count not in (None, 1)
            or (
                process_count is None
                and (_launched_world_size() or 1) > 1
            )
        ):
            # an earlier argument-less call latched single-host mode; a
            # silent no-op here (whether the cluster is requested by
            # argument or by the YAWT_* environment) would strand this
            # process outside the cluster while its peers block in the
            # coordinator
            raise RuntimeError(
                "initialize() was already called in single-host mode; "
                "a multi-host cluster must be initialised before any "
                "argument-less initialize() call"
            )
        return

    autodetect = False
    if coordinator_address is None and process_count in (None, 1):
        launched = _launched_world_size()
        if process_count == 1 or launched is None or launched <= 1:
            _initialized = True  # single host, nothing to set up
            return
        # launched under mpirun/mpiexec/srun with no explicit wiring:
        # delegate to jax.distributed's cluster auto-detection (Open
        # MPI ORTE URI, Slurm), which derives the
        # coordinator address from the launcher environment — the
        # auto-detection the reference gets from mpi4py
        autodetect = True

    import jax

    try:
        # cross-process collectives on the CPU backend require gloo; must
        # be configured before the backend initialises (no-op on GPU
        # hosts, harmless if the backend is already up)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # pragma: no cover - option absent in older jax
        pass
    try:
        if autodetect:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=process_count,
                process_id=process_id,
            )
    except Exception as exc:
        if not autodetect:
            raise
        raise RuntimeError(
            "running under a multi-process launcher (world size "
            f"{_launched_world_size()}) but jax could not derive the "
            "cluster configuration from its environment; export "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} "
            "explicitly"
        ) from exc
    _multiprocess = True
    _initialized = True
    logger.info(
        "initialised process %d of %d", process_index(), num_processes()
    )


def _cluster_active() -> bool:
    """Whether a multi-process jax cluster is actually up. Checked without
    touching ``jax.process_count()`` so that single-process callers (every
    root-guarded ``to_file``) never trigger a device-backend
    initialisation just to learn they are process 0."""
    import sys

    if "jax" not in sys.modules:
        return False
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:  # pragma: no cover - private API moved
        return _multiprocess


def process_index() -> int:
    """Index of this host process (0 on a single host)."""
    if not _cluster_active():
        return 0
    import jax

    return jax.process_index()


def num_processes() -> int:
    """Number of host processes in the job."""
    if not _cluster_active():
        return 1
    import jax

    return jax.process_count()


def on_root() -> bool:
    """Whether this process performs root-only work (logging, file I/O) —
    the analogue of the reference's ``parallel.on_root()``."""
    return process_index() == 0


def barrier(name: str = "yawt_barrier") -> None:
    """Synchronise all host processes (no-op single-host)."""
    if num_processes() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def _broadcast_payload(payload: bytes, *, is_source: bool) -> bytes:
    """Wire part of :func:`broadcast`: send pre-pickled bytes from the
    root to all processes and return them everywhere."""
    from jax.experimental import multihost_utils

    data = np.frombuffer(payload, dtype=np.uint8)
    # exchange the length first, then the padded payload
    length = multihost_utils.broadcast_one_to_all(
        np.asarray([len(data)], dtype=np.int64), is_source=is_source
    )[0]
    buffer = np.zeros(int(length), dtype=np.uint8)
    buffer[: len(data)] = data
    result = multihost_utils.broadcast_one_to_all(
        buffer, is_source=is_source
    )
    return result.tobytes()


def broadcast(value: Any, *, is_source: bool | None = None) -> Any:
    """Broadcast an arbitrary picklable host-side value from the root
    process to all processes (the analogue of the reference's recursive
    ``bcast_auto``; small metadata only — bulk data stays sharded)."""
    if num_processes() == 1:
        return value
    if is_source is None:
        is_source = on_root()

    payload = pickle.dumps(value) if is_source else b""
    return pickle.loads(_broadcast_payload(payload, is_source=is_source))


def picklable_exception(exc: BaseException) -> BaseException:
    """The exception itself if it survives a pickle round trip, else a
    RuntimeError carrying its repr — safe to send through ``broadcast``
    without stranding the receiving processes mid-collective."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"remote process failed: {exc!r}")


def run_on_root(func: Callable, *args: Any, **kwargs: Any) -> Any:
    """Execute ``func(*args, **kwargs)`` on the root process only and
    propagate its outcome — return value or exception — to every process.

    Unlike a bare ``if on_root(): func(); barrier()``, a root-side
    exception cannot deadlock the non-root processes at the barrier: the
    broadcast outcome itself is the synchronisation point, and a root
    failure is re-raised collectively on all processes so the whole job
    terminates with the real error."""
    if num_processes() == 1:
        return func(*args, **kwargs)
    if on_root():
        try:
            outcome = ("ok", func(*args, **kwargs))
        except BaseException as exc:
            outcome = ("error", exc)
        # the outcome must survive the pickled broadcast IN BOTH
        # directions: a pickle failure here would strand the non-root
        # processes in the collective, and an unpickling failure on the
        # receiving ranks is just as fatal. Verify once and send the
        # SAME bytes — no second serialisation of a large payload, and
        # the root uses its own (verified) outcome instead of
        # deserialising the broadcast echo a second time.
        try:
            wire = pickle.dumps(outcome)
            pickle.loads(wire)
        except Exception:
            status, payload = outcome
            outcome = (
                "error",
                RuntimeError(
                    f"root outcome is not picklable ({status}): "
                    f"{payload!r}"
                ),
            )
            wire = pickle.dumps(outcome)
        _broadcast_payload(wire, is_source=True)
        status, payload = outcome
    else:
        status, payload = pickle.loads(
            _broadcast_payload(b"", is_source=False)
        )
    if status == "error":
        raise payload
    return payload


def broadcasted(func: Callable) -> Callable:
    """Decorator: run ``func`` only on the root process and broadcast its
    outcome (return value or collective re-raise of an exception) to all
    processes (the analogue of the reference's ``@broadcasted``,
    /root/reference/src/yaw/utils/parallel.py:189-208)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return run_on_root(func, *args, **kwargs)

    return wrapper
