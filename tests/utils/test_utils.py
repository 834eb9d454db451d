import io
import logging
from pathlib import Path

import numpy as np
import pytest
from numpy.testing import assert_allclose

from yet_another_wizz_tpu.utils.logging import Indicator, get_logger
from yet_another_wizz_tpu.utils.misc import (
    common_len_assert,
    env_flag,
    format_float_fixed_width,
    format_long_num,
    format_time,
    groupby,
)


class TestMisc:
    def test_groupby(self):
        keys = np.array([1, 0, 1, 2, 0])
        values = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
        groups = dict(groupby(keys, values))
        assert_allclose(groups[0], [20, 50])
        assert_allclose(groups[1], [10, 30])
        assert_allclose(groups[2], [40])

    def test_common_len(self):
        assert common_len_assert([[1, 2], [3, 4]]) == 2
        with pytest.raises(ValueError):
            common_len_assert([[1], [2, 3]])

    def test_fixed_width_float(self):
        assert format_float_fixed_width(1.2345, 10) == " 1.2345000"
        assert len(format_float_fixed_width(-0.5, 10)) == 10
        assert "nan" in format_float_fixed_width(float("nan"), 10)

    def test_long_num(self):
        assert format_long_num(950) == "950"
        assert format_long_num(1234.0) == "1.23K"
        assert format_long_num(2.5e6) == "2.5M"

    def test_format_time(self):
        assert format_time(0.0) == "0m00.00s"
        assert format_time(83.5) == "1m23.50s"

    def test_thread_limit_override(self, monkeypatch):
        from yet_another_wizz_tpu.utils.misc import (
            host_thread_count,
            thread_limit,
        )

        monkeypatch.setenv("YAWT_NUM_THREADS", "7")
        with thread_limit(2):
            # an active per-call limit beats the environment
            assert host_thread_count() == 2
            assert host_thread_count(16) == 2
            with thread_limit(None):  # no-op, keeps the outer limit
                assert host_thread_count() == 2
        assert host_thread_count() == 7

    def test_host_thread_count(self, monkeypatch):
        from yet_another_wizz_tpu.utils.misc import host_thread_count

        monkeypatch.delenv("YAWT_NUM_THREADS", raising=False)
        monkeypatch.delenv("YAW_NUM_THREADS", raising=False)
        assert host_thread_count() is None
        assert host_thread_count(4) == 4
        # the reference's variable works as an alias
        monkeypatch.setenv("YAW_NUM_THREADS", "3")
        assert host_thread_count(4) == 3
        # ours wins when both are set; values clamp to >= 1
        monkeypatch.setenv("YAWT_NUM_THREADS", "0")
        assert host_thread_count() == 1
        # invalid values fall through
        monkeypatch.setenv("YAWT_NUM_THREADS", "lots")
        assert host_thread_count() == 3


class TestLogging:
    def test_get_logger_banner(self):
        stream = io.StringIO()
        logger = get_logger(
            "info", stream=stream, pretty=False, capture_exceptions=False
        )
        logger.info("hello world")
        text = stream.getvalue()
        assert "yet_another_wizz_tpu v" in text
        assert "hello world" in text
        assert "INF" in text

    def test_level_filtering(self):
        stream = io.StringIO()
        logger = get_logger(
            "warning", stream=stream, pretty=False, capture_exceptions=False
        )
        logger.info("not shown")
        logger.warning("shown")
        assert "not shown" not in stream.getvalue()
        assert "shown" in stream.getvalue()

    def test_indicator(self):
        stream = io.StringIO()
        result = list(Indicator(range(5), stream=stream, min_interval=0))
        assert result == [0, 1, 2, 3, 4]
        text = stream.getvalue()
        assert "processed 5/5 (100%)" in text


class TestPlotting:
    def test_plot_helpers_run(self):
        import matplotlib

        matplotlib.use("Agg")
        from yet_another_wizz_tpu.utils import plotting

        x = np.linspace(0, 1, 5)
        y = np.ones(5)
        err = 0.1 * np.ones(5)
        ax = plotting.point_uncertainty(x, y, err)
        plotting.line_uncertainty(x, y, err, ax=ax)
        plotting.zero_line(ax=ax)
        edges = np.linspace(0, 1, 6)
        plotting.step_uncertainty(edges, y, err, ax=ax)
        corr = np.eye(4)
        plotting.correlation_matrix(corr)

    def test_corrdata_plot(self, rng):
        import matplotlib

        matplotlib.use("Agg")
        from yet_another_wizz_tpu.binning import Binning
        from yet_another_wizz_tpu.correlation.corrdata import CorrData

        corr = CorrData(
            Binning([0.1, 0.3, 0.5]),
            rng.normal(1, 0.1, 2),
            rng.normal(1, 0.1, (5, 2)),
        )
        for style in ("point", "line", "step"):
            assert corr.plot(style=style) is not None
        assert corr.plot_corr() is not None


class TestProfiling:
    def test_profile_trace_context(self, tmp_path):
        import jax.numpy as jnp

        from yet_another_wizz_tpu.utils.logging import profile_trace

        with profile_trace(tmp_path / "trace"):
            jnp.ones(8).sum().block_until_ready()
        assert any((tmp_path / "trace").rglob("*"))


class TestPlotStyles:
    @pytest.fixture()
    def corrdata(self, rng):
        import numpy as np

        from yet_another_wizz_tpu.binning import Binning
        from yet_another_wizz_tpu.correlation.corrdata import CorrData

        binning = Binning(np.linspace(0.2, 1.0, 6))
        data = rng.uniform(1, 2, 5)
        samples = data[None, :] * rng.uniform(0.9, 1.1, (8, 5))
        return CorrData(binning, data, samples)

    @pytest.mark.parametrize("style", ["point", "line", "step"])
    def test_plot_styles(self, corrdata, style, tmp_path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ax = corrdata.plot(style=style)
        ax.figure.savefig(tmp_path / f"{style}.png")
        plt.close(ax.figure)
        assert (tmp_path / f"{style}.png").stat().st_size > 0

    def test_plot_corr_matrix(self, corrdata, tmp_path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ax = corrdata.plot_corr()
        ax.figure.savefig(tmp_path / "corr.png")
        plt.close(ax.figure)
        assert (tmp_path / "corr.png").stat().st_size > 0

    def test_unknown_style(self, corrdata):
        with pytest.raises(ValueError):
            corrdata.plot(style="sparkles")


def test_long_num_format():
    from yet_another_wizz_tpu.utils.logging import long_num_format

    assert long_num_format(999) in ("999", "999.0")
    assert "M" in long_num_format(2_500_000)
    assert "K" in long_num_format(12_000)


def test_get_options():
    from yet_another_wizz_tpu.options import Closed, get_options

    assert set(get_options(Closed)) == {"left", "right"}


class TestCompileCache:
    """The environment variable names the cache; otherwise it sits at a
    fixed path in the checkout, so every run can find it again."""

    def test_enables_at_directory(self, tmp_path, monkeypatch):
        import jax

        from yet_another_wizz_tpu.utils.compile_cache import (
            enable_persistent_compile_cache,
        )

        before = jax.config.jax_compilation_cache_dir
        target = tmp_path / "xla_cache"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        try:
            used = enable_persistent_compile_cache()
            assert used == str(target)
            assert target.is_dir()
            assert jax.config.jax_compilation_cache_dir == str(target)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_noop_without_directory(self, monkeypatch):
        """Unset, the cache goes to ``<checkout>/.jax_cache`` and to no
        temporary, per-process or per-run path."""
        import jax

        import yet_another_wizz_tpu
        from yet_another_wizz_tpu.utils.compile_cache import (
            compile_cache_dir,
            enable_persistent_compile_cache,
        )

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        checkout = Path(yet_another_wizz_tpu.__file__).resolve().parents[1]
        expected = str(checkout / ".jax_cache")
        assert compile_cache_dir() == expected
        assert compile_cache_dir() == expected  # stable between calls
        before = jax.config.jax_compilation_cache_dir
        try:
            assert enable_persistent_compile_cache() == expected
            assert jax.config.jax_compilation_cache_dir == expected
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    @pytest.mark.parametrize("value", ["", "/some/where/else"])
    def test_environment_wins(self, monkeypatch, value):
        """A set variable is used as it is; an empty one counts as unset."""
        from yet_another_wizz_tpu.utils.compile_cache import (
            CHECKOUT_CACHE,
            compile_cache_dir,
        )

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
        assert compile_cache_dir() == (value or str(CHECKOUT_CACHE))

class TestEnvFlag:
    """Boolean env flags (lives here, NOT in test_native.py: env_flag is
    pure Python and must stay tested on hosts without the native build,
    where it gates the YAWT_DISABLE_NATIVE fallback itself)."""

    @pytest.mark.parametrize(
        "value,expected",
        [
            ("1", True),
            ("true", True),
            ("YES", True),
            ("on", True),
            ("0", False),
            ("false", False),
            ("No", False),
            ("off", False),
            ("n", False),
            ("", False),
            (" 0 ", False),
        ],
    )
    def test_values(self, monkeypatch, value, expected):
        monkeypatch.setenv("YAWT_TEST_FLAG", value)
        assert env_flag("YAWT_TEST_FLAG") is expected

    def test_unset(self, monkeypatch):
        monkeypatch.delenv("YAWT_TEST_FLAG", raising=False)
        assert env_flag("YAWT_TEST_FLAG") is False


def test_client_log_level():
    """CLIENT sits between INFO and WARNING, is registered by name, the
    Logger.client() convenience emits at it, and the terminal formatter
    renders it as 'CLI' (reference cli/logging.py:71-75)."""
    import logging

    from yet_another_wizz_tpu.utils.logging import CLIENT, TerminalFormatter

    assert logging.INFO < CLIENT < logging.WARNING
    assert logging.getLevelName(CLIENT) == "CLIENT"

    logger = logging.getLogger("yawt.test_client")
    logger.setLevel(logging.INFO)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        logger.client("task progress %d", 3)
        logger.log(CLIENT, "also works")
    finally:
        logger.removeHandler(handler)
    assert [r.levelno for r in records] == [CLIENT, CLIENT]
    assert records[0].getMessage() == "task progress 3"

    rendered = TerminalFormatter(pretty=False).format(records[0])
    assert "CLI |" in rendered
