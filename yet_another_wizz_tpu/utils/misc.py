"""Generic helper functions: array grouping, HDF5 version tags, string
formatting.

Capability parity with the reference ``yaw.utils.misc``
(/root/reference/src/yaw/utils/misc.py:36-97): HDF5 compression defaults and
version tagging (including detection of legacy v2 files), groupby over numpy
arrays, and fixed-width float formatting for the ASCII serialisation.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu._version import __version__

if TYPE_CHECKING:
    from collections.abc import Generator, Iterable, Sized
    from io import TextIOBase
    from typing import Any

    from numpy.typing import NDArray

__all__ = [
    "HDF_COMPRESSION",
    "env_flag",
    "groupby",
    "common_len_assert",
    "write_version_tag",
    "load_version_tag",
    "is_legacy_dataset",
    "format_float_fixed_width",
    "format_long_num",
    "format_time",
    "write_yaml",
    "host_thread_count",
    "thread_limit",
]

HDF_COMPRESSION = dict(fletcher32=True, compression="gzip", shuffle=True)
"""Default compression options applied to HDF5 datasets."""


def env_flag(name: str) -> bool:
    """Boolean environment flag: unset, empty, and the conventional
    negative spellings (``0``, ``false``, ``no``, ``off``, ``n``) are off
    — so ``YAWT_DISABLE_NATIVE=0`` really means "do not disable". Lives
    here (not in ``_native``) so flag parsing never triggers the native
    library build as an import side effect."""
    import os

    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off", "n",
    )


_THREAD_LIMIT_OVERRIDE: ContextVar[int | None] = ContextVar(
    "yawt_thread_limit", default=None
)


def thread_limit(max_workers: int | None):
    """Context manager bounding host worker pools created inside it.

    The per-call analogue of the ``YAWT_NUM_THREADS`` environment knob:
    every pool that sizes itself through :func:`host_thread_count` (the
    float64 oracle processes, parallel patch-cache reopening) respects the
    bound while the context is active. ``None`` is a no-op, mirroring the
    reference's optional ``max_workers`` argument
    (/root/reference/src/yaw/utils/parallel.py:53-85)."""
    import contextlib

    @contextlib.contextmanager
    def _limit():
        if max_workers is None:
            yield
            return
        token = _THREAD_LIMIT_OVERRIDE.set(max(1, int(max_workers)))
        try:
            yield
        finally:
            _THREAD_LIMIT_OVERRIDE.reset(token)

    return _limit()


def host_thread_count(default: int | None = None) -> int | None:
    """Host-side worker-pool size from the environment.

    An active :func:`thread_limit` context takes precedence; otherwise
    reads ``YAWT_NUM_THREADS`` and falls back to the reference's
    ``YAW_NUM_THREADS`` (/root/reference/src/yaw/utils/parallel.py:75-85)
    so existing deployments keep their knob. Invalid values are ignored
    with a warning. Returns ``default`` when neither is set."""
    import os

    override = _THREAD_LIMIT_OVERRIDE.get()
    if override is not None:
        return override

    for name in ("YAWT_NUM_THREADS", "YAW_NUM_THREADS"):
        env = os.environ.get(name)
        if env:
            try:
                return max(1, int(env))
            except ValueError:
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring invalid %s=%r", name, env
                )
    return default


def groupby(keys: NDArray, values: NDArray) -> Generator[tuple[Any, NDArray]]:
    """Group ``values`` along their first axis by unique entries of ``keys``.

    Yields ``(key, values_for_key)`` pairs in sorted key order. Uses a stable
    sort so the relative order of rows within a group is preserved.
    """
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    sorted_vals = values[order]
    unique, first_idx = np.unique(sorted_keys, return_index=True)
    for key, chunk in zip(unique, np.split(sorted_vals, first_idx[1:])):
        yield key, chunk


def common_len_assert(items: Iterable[Sized]) -> int:
    """Assert all containers share one length and return it."""
    lengths = {len(item) for item in items}
    if len(lengths) > 1:
        raise ValueError("length of inputs does not match")
    (length,) = lengths or {0}
    return length


def write_version_tag(dest) -> None:
    """Stamp an HDF5 group with the current code version."""
    dest.create_dataset("version", data=__version__)


def load_version_tag(source) -> str:
    """Read the code version stamp from an HDF5 group (``2.x.x`` if absent,
    matching the reference's legacy convention)."""
    try:
        return source["version"][()].decode("utf-8")
    except KeyError:
        return "2.x.x"


def is_legacy_dataset(source) -> bool:
    """Whether an HDF5 group was produced by the reference's v2 format."""
    return "version" not in source


def format_float_fixed_width(value: float, width: int) -> str:
    """Format a float as a fixed-width string (used by ASCII output files)."""
    string = f"{value: .{width}f}"
    if "nan" in string or "inf" in string:
        string = f"{string.rstrip():>{width}s}"
    num_int_digits = len(string.split(".")[0])
    return string[: max(width, num_int_digits)]


def format_long_num(value: float | int) -> str:
    """Format a number with a 1000-step suffix, e.g. ``1234.0 -> '1.23K'``."""
    value = float(f"{value:.3g}")
    magnitude = 0
    while abs(value) >= 1000.0:
        magnitude += 1
        value /= 1000.0
    suffix = ["", "K", "M", "B", "T"][magnitude]
    return f"{value:g}{suffix}"


def format_time(elapsed: float) -> str:
    """Format a duration in seconds as ``MmSS.SSs``."""
    minutes, seconds = divmod(elapsed, 60.0)
    return f"{int(minutes)}m{seconds:05.2f}s"


def write_yaml(data: dict, file: TextIOBase, **kwargs) -> None:
    """Serialise a dictionary to YAML with consistent defaults."""
    import yaml

    kwargs.setdefault("default_flow_style", False)
    kwargs.setdefault("sort_keys", False)
    yaml.safe_dump(data, file, **kwargs)
