"""Framework-side accounting of resident device (HBM) bytes.

On the GPU, ``jax.Device.memory_stats()["peak_bytes_in_use"]`` reports
the peak of everything the process allocated, transient scratch
included. This ledger answers a narrower question: which long-lived
arrays the framework itself retains, by label — the quantity the
out-of-core path's "bounded device memory" guarantee is about.
``chip_smoke.py`` prints both numbers side by side. The framework knows
every long-lived device array it creates —
decoded tile lanes, the blocked accumulator, edge tables, deferred
engine outputs — so it accounts for them itself: :func:`track` charges
an array's bytes to a label when it is created and automatically
credits them back when the array is garbage-collected (a weakref
finalizer — no explicit release calls to forget, no double-free
hazards).

The ledger is a process-wide diagnostic, not an allocator: it measures
what the framework *retains*, the quantity the blocked path bounds.
Transient per-call scratch inside jitted programs is XLA's domain and
is excluded by design (it is bounded by the compiled program's fixed
buffer plan, not by framework policy).

Read it with :func:`snapshot`; scope a measurement with
:func:`reset_peak` before and ``snapshot()["peak_bytes"]`` after.
"""

from __future__ import annotations

import threading
import weakref

__all__ = [
    "reset_peak",
    "snapshot",
    "track",
]

_lock = threading.Lock()
_current = 0
_peak = 0
_current_by_label: dict[str, int] = {}
_peak_by_label: dict[str, int] = {}


def _nbytes(value) -> int:
    total = 0
    leaves = value if isinstance(value, (list, tuple)) else [value]
    for leaf in leaves:
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def _release(nbytes: int, label: str) -> None:
    global _current
    with _lock:
        _current -= nbytes
        _current_by_label[label] = _current_by_label.get(label, 0) - nbytes


def track(array, label: str):
    """Charge ``array``'s bytes (an array or a flat list/tuple of
    arrays) to ``label`` until it is garbage-collected. Returns the
    array unchanged, so call sites wrap in place::

        token = track(decode(...), "tile_lanes")
    """
    global _current, _peak
    nbytes = _nbytes(array)
    if nbytes == 0:
        return array
    with _lock:
        _current += nbytes
        _current_by_label[label] = (
            _current_by_label.get(label, 0) + nbytes
        )
        if _current > _peak:
            _peak = _current
        if _current_by_label[label] > _peak_by_label.get(label, 0):
            _peak_by_label[label] = _current_by_label[label]
    holder = array[0] if isinstance(array, (list, tuple)) else array
    try:
        weakref.finalize(holder, _release, nbytes, label)
    except TypeError:
        # non-weakreferenceable leaf (e.g. a plain numpy view on the
        # host test platform): credit back immediately rather than
        # leak accounting forever
        _release(nbytes, label)
    return array


def track_if_device(value, label: str):
    """Like :func:`track`, but only charges genuine ``jax.Array``
    values — host-side numpy results (audit repairs, the oracle
    backend) pass through unaccounted."""
    import jax

    if isinstance(value, jax.Array):
        return track(value, label)
    return value


def reset_peak() -> None:
    """Reset the peak watermarks to the CURRENT residency (start of a
    measured window). Live arrays stay charged — a peak must never
    read below what is resident right now."""
    global _peak
    with _lock:
        _peak = _current
        _peak_by_label.clear()
        _peak_by_label.update(
            {k: v for k, v in _current_by_label.items() if v > 0}
        )


def snapshot() -> dict:
    """Current and peak framework-accounted device bytes, total and by
    label (labels with zero current residency are dropped from the
    current view but keep their peak)."""
    with _lock:
        return {
            "current_bytes": _current,
            "peak_bytes": _peak,
            "current_by_label": {
                k: v for k, v in _current_by_label.items() if v > 0
            },
            "peak_by_label": dict(_peak_by_label),
        }
