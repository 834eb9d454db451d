"""yet_another_wizz_tpu: an accelerator-native clustering-redshift framework.

A from-scratch JAX/XLA/Pallas implementation of the clustering-redshift
estimation method (Schmidt et al. 2013; van den Busch et al. 2020) with the
capabilities of `yet_another_wizz` (v3 API): catalog ingestion with spatial
patches, angular pair counting per redshift slice, Davis-Peebles /
Landy-Szalay estimators, jackknife & bootstrap patch resampling, and n(z)
recovery.

The compute core replaces the reference's per-patch scipy kd-trees with a
tiled brute-force pair-count engine that runs on the GPU: spatially sorted
point tiles, elementwise chord-distance evaluation with (hi, lo) float32
compensated arithmetic, cumulative threshold histograms and exact per-bin
reductions (a Pallas kernel or plain XLA); multi-device execution shards
the tile-pair grid over a ``jax.sharding.Mesh``.
"""

from yet_another_wizz_tpu._version import __version__, __version_tuple__
from yet_another_wizz_tpu.binning import Binning
from yet_another_wizz_tpu.coordinates import AngularCoordinates, AngularDistances
from yet_another_wizz_tpu.cosmology import (
    CustomCosmology,
    FLRWCosmology,
    Planck15,
    cosmology_is_equal,
    get_default_cosmology,
    new_scales,
)

__all__ = [
    "AngularCoordinates",
    "AngularDistances",
    "Binning",
    "BoxRandoms",
    "HealPixRandoms",
    "Catalog",
    "Configuration",
    "CorrData",
    "CorrFunc",
    "CustomCosmology",
    "FLRWCosmology",
    "HistData",
    "LazyCatalog",
    "Planck15",
    "RedshiftData",
    "ScalarCorrFunc",
    "__version__",
    "__version_tuple__",
    "autocorrelate",
    "autocorrelate_scalar",
    "cosmology_is_equal",
    "crosscorrelate",
    "crosscorrelate_scalar",
    "get_default_cosmology",
    "load_corrfunc",
    "new_scales",
]


def __getattr__(name):
    # Late imports keep the base package importable while higher layers are
    # under construction and avoid importing jax for config-only use cases.
    if name in ("Catalog", "LazyCatalog"):
        from yet_another_wizz_tpu import catalog

        return getattr(catalog, name)
    if name in ("Configuration",):
        from yet_another_wizz_tpu.config import Configuration

        return Configuration
    if name in ("CorrData", "CorrFunc", "ScalarCorrFunc", "load_corrfunc"):
        from yet_another_wizz_tpu import correlation

        return getattr(correlation, name)
    if name in (
        "autocorrelate",
        "crosscorrelate",
        "autocorrelate_scalar",
        "crosscorrelate_scalar",
    ):
        from yet_another_wizz_tpu.correlation import measurements

        return getattr(measurements, name)
    if name in ("HistData", "RedshiftData"):
        from yet_another_wizz_tpu import redshifts

        return getattr(redshifts, name)
    if name in ("BoxRandoms", "HealPixRandoms"):
        from yet_another_wizz_tpu import randoms

        return getattr(randoms, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
