"""Spherical kmeans for patch center generation and assignment.

Replaces the reference's native dependencies for patch handling:
``treecorr`` C++ kmeans for center creation
(/root/reference/src/yaw/catalog/catalog.py:183-226) and
``scipy.cluster.vq.vq`` for nearest-center assignment (same file :229-249).

Center generation runs on a bounded probe subsample with deterministic
kmeans++ seeding and vectorised Lloyd iterations on the host (like the
reference's treecorr call, the clustering itself is a small host-side
problem); the O(N * P) assignment of the full catalog is a device matmul
argmax. Unlike treecorr (whose centers are non-deterministic, reference
docs ``concepts.rst:109-111``), results are reproducible for a fixed seed.

Device matmuls use ``Precision.HIGHEST``: a reduced-precision matmul (TF32
on the GPU) cannot separate nearby sky positions and collapses clusters.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "assign_patches",
    "kmeans_patch_centers",
]

DEFAULT_KMEANS_ITERATIONS = 30


def _seed_centers_plusplus(
    xyz: NDArray, weights: NDArray, num_patches: int, rng
) -> NDArray:
    """Deterministic kmeans++ seeding: each new center is drawn with
    probability proportional to the weighted squared distance to the
    nearest existing center."""
    from yet_another_wizz_tpu import _native

    centers = np.empty((num_patches, 3))
    centers[0] = xyz[rng.integers(len(xyz))]
    min_d2 = np.full(len(xyz), np.inf)
    xyz_c = np.ascontiguousarray(xyz, dtype=np.float64)
    for idx in range(1, num_patches):
        if _native.NATIVE_ENABLED:
            _native.min_dist2_update(xyz_c, centers[idx - 1], min_d2)
        else:
            d2 = np.sum((xyz - centers[idx - 1]) ** 2, axis=1)
            np.minimum(min_d2, d2, out=min_d2)
        probs = min_d2 * weights
        total = probs.sum()
        if total <= 0:
            centers[idx] = xyz[rng.integers(len(xyz))]
            continue
        centers[idx] = xyz[rng.choice(len(xyz), p=probs / total)]
    return centers


def kmeans_patch_centers(
    xyz: NDArray,
    num_patches: int,
    *,
    weights: NDArray | None = None,
    probe_size: int | None = None,
    seed: int = 12345,
    iterations: int = DEFAULT_KMEANS_ITERATIONS,
) -> NDArray:
    """Generate ``num_patches`` patch centers on the unit sphere.

    A uniform random probe subsample (the reference's ``probe_size``
    logic) bounds the clustering cost for large catalogs.

    Returns float64 unit vectors of shape ``(num_patches, 3)``.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    if len(xyz) < num_patches:
        raise ValueError("catalog has fewer points than requested patches")
    weights = (
        np.ones(len(xyz)) if weights is None else np.asarray(weights, float)
    )

    rng = np.random.default_rng(seed)
    if probe_size is not None and probe_size < len(xyz):
        # the probe must still over-determine the centers, or the
        # kmeans++ seeding draws duplicates and leaves patches
        # permanently empty with no error raised
        if probe_size < num_patches:
            raise ValueError(
                f"'probe_size' ({probe_size}) must be at least "
                f"'num_patches' ({num_patches})"
            )
        idx = rng.choice(len(xyz), probe_size, replace=False)
        xyz, weights = xyz[idx], weights[idx]

    centers = _seed_centers_plusplus(xyz, weights, num_patches, rng)
    weighted_xyz = np.ascontiguousarray(xyz * weights[:, None])
    for _ in range(iterations):
        labels = assign_patches(xyz, centers)
        sums = np.stack(
            [
                np.bincount(
                    labels, weights=weighted_xyz[:, dim],
                    minlength=num_patches,
                )
                for dim in range(3)
            ],
            axis=1,
        )
        norms = np.linalg.norm(sums, axis=1)
        # empty clusters keep their previous center
        update = norms > 0
        centers[update] = sums[update] / norms[update, None]

    return centers / np.linalg.norm(centers, axis=1, keepdims=True)


@jax.jit
def _assign_device(xyz: jnp.ndarray, centers: jnp.ndarray) -> jnp.ndarray:
    return jnp.argmax(
        jax.lax.dot_general(
            xyz, centers,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ),
        axis=1,
    )


DEVICE_ASSIGN_THRESHOLD = 2e9
"""Below this ``num_points * num_centers`` product the host matmul wins
over the device round trip."""


def assign_patches(
    xyz: NDArray, centers: NDArray, chunk: int = 4_000_000
) -> NDArray:
    """Assign each point to its nearest patch center (greatest dot
    product), the analogue of ``scipy.cluster.vq.vq`` on unit vectors.

    Small problems run as a host matmul; large catalogs stream through
    the device in chunks (matmul argmax)."""
    xyz = np.asarray(xyz)
    if len(xyz) * len(centers) < DEVICE_ASSIGN_THRESHOLD:
        from yet_another_wizz_tpu import _native

        if _native.NATIVE_ENABLED:
            return _native.assign_patches(xyz, centers)
        # bounded temporaries: the (chunk, centers) float64 score matrix
        # plus one equal-size broadcast temporary stay within ~100 MB
        # (the bound counts BYTES: 2 arrays x 8 B per element); scores
        # via broadcast ufuncs — BLAS gemm with an inner dimension of 3
        # is pathologically slow on some builds
        host_chunk = max(
            1, int(100_000_000 / (16 * max(len(centers), 1)))
        )
        centers_t = np.asarray(centers, np.float64).T
        out = np.empty(len(xyz), dtype=np.int32)
        for start in range(0, len(xyz), host_chunk):
            block = xyz[start : start + host_chunk]
            scores = block[:, 0, None] * centers_t[0]
            scores += block[:, 1, None] * centers_t[1]
            scores += block[:, 2, None] * centers_t[2]
            out[start : start + host_chunk] = np.argmax(scores, axis=1)
        return out

    centers_dev = jnp.asarray(centers, jnp.float32)
    out = np.empty(len(xyz), dtype=np.int32)
    for start in range(0, len(xyz), chunk):
        block = jnp.asarray(xyz[start : start + chunk], jnp.float32)
        out[start : start + chunk] = np.asarray(
            jax.device_get(_assign_device(block, centers_dev))
        )
    return out
