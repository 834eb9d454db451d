"""Per-pair separation weights for the direct counting mode.

Shared by the XLA path (:mod:`yet_another_wizz_tpu.ops.paircount`) and the
Pallas GPU kernel (:mod:`yet_another_wizz_tpu.ops.pallas_paircount`): all
operations are elementwise jax.numpy that lowers both in plain XLA and in
the Pallas Triton route. See :class:`yet_another_wizz_tpu.ops.thresholds.DirectEdges` for
the table layout and the exact-equivalence argument versus the reference's
union-edge histogram (/root/reference/src/yaw/catalog/trees.py:84-117).

Cost: one fixed block of elementwise passes per tile pair replacing the ~3 passes
PER SUB-EDGE of cumulative counting. Grids confined to small angles (every
survey-relevant configuration; gate :data:`THETA_POLY_MAX`) take the cheap
small-angle path — ``log10(theta)`` straight from the squared chord through
one log and a short polynomial, no sqrt/arcsine — while wider grids keep
the explicit ``sqrt -> arcsine -> log`` chain.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "THETA_POLY_MAX",
    "apply_direct_weight",
    "counting_width",
    "num_param_cols",
]

_INV_LN10 = 0.43429448190325176
_PI_2 = 1.5707963267948966

THETA_POLY_MAX = 1.2
"""Largest grid edge (radians) for the small-angle direct path.

``log10(theta)`` decomposes as ``0.5 * log10(chord2) + h(chord2 / 4)``
with ``h(y) = log10(asin(sqrt(y)) / sqrt(y))`` — analytic in ``y``, so a
degree-4 polynomial (times ``y``; ``h(0) = 0`` exactly) covers
``theta <= 1.2 rad`` to 3.7e-8 in float64. The float32 evaluation lands
at 6.0e-7 max error in ``log10(theta)`` versus the explicit
``sqrt -> arcsine -> log`` chain's 6.2e-7 (measured over 2M pairs,
theta in [1e-6, 1.2]): the same error class, so sub-interval boundary
wobble is unchanged while two sqrts and the ~13-op arcsine block drop
from the per-pair cost. Pairs beyond the grid cannot leak through the
gate: scale limits compare ``chord2`` directly, pairs above the largest
counting edge enter no cumulative sum, and pairs below the smallest
cancel between the two edge sums that bracket their scale (see
``apply_direct_weight``)."""

_H_POLY = (
    # power-basis coefficients of h(y)/y over [0, sin^2(THETA_POLY_MAX/2)],
    # a0 + a1 y + ... + a4 y^4 (Chebyshev fit converted; a0 -> 1/(6 ln 10))
    0.072382861485278921,
    0.026515311180259658,
    0.015040318719047438,
    0.0068128827079525812,
    0.014413456335465801,
)


def num_param_cols(num_below: int, num_above: int) -> int:
    """Width of the per-bin parameter block appended to the threshold
    table: ``[inv_d, lo_scaled, gc0, gc1]`` plus 3 columns per entry."""
    return 4 + 3 * (num_below + num_above)


def counting_width(num_table_cols: int, direct: tuple | None) -> int:
    """Counting-edge columns of a (possibly combined) threshold table:
    the full width in cumulative mode, the width minus the parameter
    block in direct mode (``direct = (num_sub, num_below, num_above)``)."""
    if direct is None:
        return num_table_cols
    return num_table_cols - num_param_cols(direct[1], direct[2])


def _asin_f32(s):
    """Branchless float32 arcsine on [0, 1].

    Small arguments use the classic single-precision minimax polynomial
    (Cephes asinf coefficients, ~1 ulp on [0, 0.5]); larger ones go
    through ``asin(s) = pi/2 - 2 asin(sqrt((1 - s) / 2))``, whose inner
    argument is again <= 0.5. Written out explicitly so that every
    engine evaluates the same polynomial, independent of which arcsine a
    compiler's math library provides.
    """
    big = s > 0.5
    t = jnp.where(big, jnp.sqrt(jnp.maximum(0.5 * (1.0 - s), 0.0)), s)
    z = t * t
    p = (
        (((4.2163199048e-2 * z + 2.4181311049e-2) * z + 4.5470025998e-2) * z
         + 7.4953002686e-2) * z + 1.6666752422e-1
    )
    r = t + t * z * p
    return jnp.where(big, _PI_2 - 2.0 * r, r)


def apply_direct_weight(
    chord2,
    params,
    weights,
    *,
    num_sub: int,
    num_below: int,
    num_above: int,
    small_angle: bool = False,
):
    """Multiply pair ``weights`` by the normalised separation weight.

    Args:
        chord2: ``(T, T)`` squared chord distances.
        params: the ``C == num_param_cols(...)`` per-row parameter
            columns, each ``(T, 1)``, selected from the per-bin table.
        weights: ``(T, T)`` effective column weights to scale.
        num_sub / num_below / num_above: static grid configuration, see
            :class:`~yet_another_wizz_tpu.ops.thresholds.DirectEdges`.

    The sub-interval index comes from the uniform log grid in O(1):
    ``floor(log10(theta) * inv_d - lo_scaled)`` with
    ``theta = 2 asin(sqrt(chord2) / 2)``; the base weight is
    ``exp(gc0 + gc1 * idx)`` and the below/above entries repair the
    sub-intervals split by interior scale limits. Pairs outside the grid
    clip to the end intervals — they either cancel between the cumulative
    scale-edge sums (below the minimum) or never enter one (above the
    maximum), so their weight value is irrelevant.

    With ``small_angle=True`` (static; set by ``DirectEdges.spec`` when
    every grid edge is at most :data:`THETA_POLY_MAX`) ``log10(theta)``
    is evaluated directly from the squared chord as
    ``0.5 * log10(chord2) + h(chord2 / 4)`` — one log plus five FMAs
    instead of sqrt, the branchless arcsine block and its internal
    sqrt. Pairs wider than the fitted range receive a wrong index, but
    the gate guarantees those lie beyond every counting edge, where the
    weight value cannot reach any output (see above and
    :data:`THETA_POLY_MAX`).
    """
    inv_d, lo_scaled, gc0, gc1 = params[:4]

    if small_angle:
        y = 0.25 * chord2
        p = _H_POLY[4]
        for a in (_H_POLY[3], _H_POLY[2], _H_POLY[1], _H_POLY[0]):
            p = p * y + a
        # clamp to a float32-NORMAL value: 1e-30 squared would flush to
        # zero, and log(0) = -inf turns into NaN against the zero inv_d
        # of padded empty bins
        log10_theta = (
            0.5 * _INV_LN10
        ) * jnp.log(jnp.maximum(chord2, 1e-37)) + p * y
    else:
        s = jnp.minimum(0.5 * jnp.sqrt(chord2), 1.0)
        theta = 2.0 * _asin_f32(s)
        log10_theta = jnp.log(jnp.maximum(theta, 1e-30)) * _INV_LN10
    idx = jnp.clip(
        jnp.floor(log10_theta * inv_d - lo_scaled),
        0.0,
        float(num_sub - 1),
    )
    g = jnp.exp(gc0 + gc1 * idx)

    col = 4
    for _ in range(num_below):
        k, thr, value = params[col : col + 3]
        g = jnp.where((idx == k) & (chord2 <= thr), value, g)
        col += 3
    # ascending above-entries: a pair lands on the highest limit below it
    for _ in range(num_above):
        k, thr, value = params[col : col + 3]
        g = jnp.where((idx == k) & (chord2 > thr), value, g)
        col += 3
    return weights * g
