"""Pipeline/CLI integration tests: a matrix of invalid setups asserting the
exact configuration errors, plus end-to-end runs of valid setups.

Mirrors the reference test strategy
(/root/reference/tests/test_setups.py:47-168).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from yet_another_wizz_tpu.cli.pipeline import run_setup
from yet_another_wizz_tpu.config import ConfigError
from yet_another_wizz_tpu.examples import generate_mock_data


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """Mock catalogs written as parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("data")
    mock = generate_mock_data(
        num_reference=2500, num_unknown=4000, num_randoms=8000, seed=42
    )

    paths = {}
    for name, sample in mock.items():
        table = pa.table(
            dict(
                ra=np.rad2deg(sample["ra"]),
                dec=np.rad2deg(sample["dec"]),
                z=sample["redshifts"],
                wei=sample["weights"],
            )
        )
        paths[name] = str(root / f"{name}.pqt")
        pq.write_table(table, paths[name])
    return paths


def base_setup(paths, tasks):
    return dict(
        correlation=dict(
            scales=dict(rmin=500, rmax=3000, unit="kpc"),
            binning=dict(zmin=0.15, zmax=1.0, num_bins=4),
        ),
        inputs=dict(
            reference=dict(
                path_data=paths["reference"],
                path_rand=paths["randoms"],
                ra="ra", dec="dec", redshift="z", weight="wei",
            ),
            unknown=dict(
                path_data={1: paths["unknown"]},
                path_rand={1: paths["randoms"]},
                ra="ra", dec="dec", redshift="z", weight="wei",
            ),
            num_patches=4,
        ),
        tasks=tasks,
    )


def run(tmp_path, setup, **kwargs):
    import yaml

    setup_path = tmp_path / "setup.yml"
    with setup_path.open("w") as f:
        yaml.safe_dump(setup, f)
    kwargs.setdefault("quiet", True)
    return run_setup(tmp_path / "project", setup_path, **kwargs)


class TestInvalidSetups:
    def test_missing_scales(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["correlation"]["scales"]
        with pytest.raises(ConfigError, match="scales"):
            run(tmp_path, setup)

    def test_missing_binning(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["correlation"]["binning"]
        with pytest.raises(ConfigError, match="binning"):
            run(tmp_path, setup)

    def test_extra_key_rejected(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        setup["correlation"]["scales"]["spam"] = 1
        with pytest.raises(ConfigError, match="scales"):
            run(tmp_path, setup)

    def test_unknown_task(self, data_files, tmp_path):
        setup = base_setup(data_files, ["correlate_everything"])
        with pytest.raises(ConfigError, match="unknown task"):
            run(tmp_path, setup)

    def test_no_tasks(self, data_files, tmp_path):
        setup = base_setup(data_files, [])
        with pytest.raises(ConfigError, match="task"):
            run(tmp_path, setup)

    def test_auto_ref_without_randoms(self, data_files, tmp_path):
        setup = base_setup(data_files, ["auto_ref"])
        del setup["inputs"]["reference"]["path_rand"]
        with pytest.raises(ConfigError, match="path_rand"):
            run(tmp_path, setup)

    def test_cross_without_any_randoms(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["inputs"]["reference"]["path_rand"]
        del setup["inputs"]["unknown"]["path_rand"]
        with pytest.raises(ConfigError, match="randoms"):
            run(tmp_path, setup)

    def test_hist_without_redshifts(self, data_files, tmp_path):
        setup = base_setup(data_files, ["hist"])
        del setup["inputs"]["unknown"]["redshift"]
        with pytest.raises(ConfigError, match="redshift"):
            run(tmp_path, setup)

    def test_reference_missing_redshift(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["inputs"]["reference"]["redshift"]
        with pytest.raises(ConfigError, match="redshift"):
            run(tmp_path, setup)

    def test_missing_patch_source(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["inputs"]["num_patches"]
        with pytest.raises(ConfigError, match="patch source"):
            run(tmp_path, setup)

    def test_invalid_num_patches(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        setup["inputs"]["num_patches"] = "plenty"
        with pytest.raises(ConfigError, match="num_patches"):
            run(tmp_path, setup)
        setup["inputs"]["num_patches"] = 0
        with pytest.raises(ConfigError, match="num_patches"):
            run(tmp_path, setup)

    def test_colliding_bin_indices(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        # "1" and 1 collide after integer conversion — a silent dict
        # collision would drop a tomographic bin
        setup["inputs"]["unknown"]["path_data"] = {
            "1": data_files["unknown"], 1: data_files["unknown"],
        }
        del setup["inputs"]["unknown"]["path_rand"]
        with pytest.raises(ConfigError, match="not unique"):
            run(tmp_path, setup)

    def test_mismatched_tomographic_rand_bins(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        setup["inputs"]["unknown"]["path_rand"] = {2: data_files["randoms"]}
        with pytest.raises(ConfigError, match="bin indices"):
            run(tmp_path, setup)

    def test_missing_input_file(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        setup["inputs"]["reference"]["path_data"] = "/does/not/exist.pqt"
        with pytest.raises(FileNotFoundError):
            run(tmp_path, setup)

    def test_auto_unk_without_randoms(self, data_files, tmp_path):
        setup = base_setup(data_files, ["auto_unk"])
        del setup["inputs"]["unknown"]["path_rand"]
        with pytest.raises(ConfigError, match="randoms"):
            run(tmp_path, setup)

    def test_auto_unk_without_redshifts(self, data_files, tmp_path):
        setup = base_setup(data_files, ["auto_unk"])
        del setup["inputs"]["unknown"]["redshift"]
        with pytest.raises(ConfigError, match="redshift"):
            run(tmp_path, setup)

    def test_reference_missing_coordinate_column(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        del setup["inputs"]["reference"]["dec"]
        with pytest.raises(ConfigError):
            run(tmp_path, setup)

    def test_cross_with_all_randoms_removed(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        del setup["inputs"]["reference"]["path_rand"]
        del setup["inputs"]["unknown"]["path_rand"]
        with pytest.raises(ConfigError, match="random"):
            run(tmp_path, setup)

    def test_reference_without_unknown_for_cross(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr"])
        del setup["inputs"]["unknown"]
        with pytest.raises(ConfigError, match="unknown"):
            run(tmp_path, setup)


@pytest.mark.slow
class TestValidSetups:
    def test_only_wsp(self, data_files, tmp_path):
        pipeline = run(
            tmp_path, base_setup(data_files, ["cross_corr", "estimate"])
        )
        project = pipeline.project
        assert project.paircounts.cross[1].exists()
        assert project.estimate.nz_est[1].exists()
        assert not project.paircounts.auto_ref.exists()

    def test_quiet_run_still_fills_pipeline_log(self, data_files, tmp_path):
        """--quiet disables TERMINAL logging only; the per-project
        pipeline.log must still record the run (the reference's file
        handler is independent of console verbosity), and the
        user-facing task lines carry the CLIENT level (INFO+5,
        reference cli/logging.py:71-75)."""
        pipeline = run(
            tmp_path, base_setup(data_files, ["cross_corr"]), quiet=True
        )
        content = pipeline.project.log_path.read_text()
        assert "CLIENT" in content
        assert "running task 'cross_corr'" in content
        assert "task 'cross_corr' finished after" in content
        assert "processing bin 1 / 1" in content
        # the task lines specifically are CLIENT-level records
        for line in content.splitlines():
            if "running task 'cross_corr'" in line:
                assert "CLIENT" in line

    def test_full_pipeline_with_plots(self, data_files, tmp_path):
        tasks = ["auto_ref", "auto_unk", "cross_corr", "estimate", "hist", "plot"]
        pipeline = run(tmp_path, base_setup(data_files, tasks))
        project = pipeline.project
        assert project.paircounts.auto_ref.exists()
        assert project.paircounts.auto_unk[1].exists()
        assert project.estimate.nz_est[1].exists()
        assert project.true.nz_true[1].exists()
        assert (project.plot_path / "nz_estimate.png").exists()

    def test_only_hist(self, data_files, tmp_path):
        pipeline = run(tmp_path, base_setup(data_files, ["hist"]))
        assert pipeline.project.true.nz_true[1].exists()

    def test_resume_skips_completed(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        run(tmp_path, setup)
        resumed = run_setup(
            tmp_path / "project", resume=True, quiet=True
        )
        assert len(resumed.tasks) == 0

    def test_lockfile_released(self, data_files, tmp_path):
        pipeline = run(tmp_path, base_setup(data_files, ["hist"]))
        assert not pipeline.project.lock_path.exists()

    def test_drop_cache(self, data_files, tmp_path):
        pipeline = run(
            tmp_path, base_setup(data_files, ["hist"]), drop=True
        )
        assert not (pipeline.project.path / "cache" / "unknown_1").exists()

    # the reference's remaining expect_pass combinations
    # (/root/reference/tests/setups/expect_pass/*.yml)

    def test_only_wss(self, data_files, tmp_path):
        pipeline = run(tmp_path, base_setup(data_files, ["auto_ref"]))
        project = pipeline.project
        assert project.paircounts.auto_ref.exists()
        assert not project.paircounts.cross[1].exists()

    def test_only_wpp(self, data_files, tmp_path):
        pipeline = run(tmp_path, base_setup(data_files, ["auto_unk"]))
        assert pipeline.project.paircounts.auto_unk[1].exists()

    def test_no_wss(self, data_files, tmp_path):
        tasks = ["auto_unk", "cross_corr", "estimate"]
        pipeline = run(tmp_path, base_setup(data_files, tasks))
        project = pipeline.project
        assert project.estimate.nz_est[1].exists()
        assert not project.paircounts.auto_ref.exists()

    def test_no_wpp(self, data_files, tmp_path):
        tasks = ["auto_ref", "cross_corr", "estimate"]
        pipeline = run(tmp_path, base_setup(data_files, tasks))
        project = pipeline.project
        assert project.estimate.nz_est[1].exists()
        assert project.estimate.auto_ref.exists()

    def test_no_unk_z(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        del setup["inputs"]["unknown"]["redshift"]
        pipeline = run(tmp_path, setup)
        assert pipeline.project.estimate.nz_est[1].exists()

    def test_only_wsp_no_ref_rand(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        del setup["inputs"]["reference"]["path_rand"]
        pipeline = run(tmp_path, setup)
        assert pipeline.project.estimate.nz_est[1].exists()

    def test_only_wsp_no_unk_rand(self, data_files, tmp_path):
        setup = base_setup(data_files, ["cross_corr", "estimate"])
        del setup["inputs"]["unknown"]["path_rand"]
        pipeline = run(tmp_path, setup)
        assert pipeline.project.estimate.nz_est[1].exists()


@pytest.mark.slow
class TestGoldenRegression:
    def test_pipeline_matches_direct_api(self, data_files, tmp_path):
        """The pipeline result must equal a direct API computation on the
        same inputs (the reference's golden-output gate,
        /root/reference/tests/test_setups.py:149-168)."""
        from numpy.testing import assert_array_almost_equal

        from yet_another_wizz_tpu import Catalog, Configuration
        from yet_another_wizz_tpu.correlation.measurements import (
            autocorrelate,
            crosscorrelate,
        )
        from yet_another_wizz_tpu.redshifts import RedshiftData

        tasks = ["auto_ref", "cross_corr", "estimate"]
        setup = base_setup(data_files, tasks)
        # no unknown randoms: the direct computation below uses RD only
        del setup["inputs"]["unknown"]["path_rand"]
        pipeline = run(tmp_path, setup)
        nz_pipeline = pipeline.project.estimate.nz_est[1].load()

        config = Configuration.create(
            rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
        )
        kwargs = dict(ra_name="ra", dec_name="dec", redshift_name="z",
                      weight_name="wei")
        # pipeline derives shared centers from the first cached catalog
        # (the reference randoms); reuse them for parity
        centers = pipeline.project.cache.get_patch_centers()
        reference = Catalog.from_file(
            None, data_files["reference"], **kwargs, patch_centers=centers
        )
        randoms = Catalog.from_file(
            None, data_files["randoms"], **kwargs, patch_centers=centers
        )
        unknown = Catalog.from_file(
            None, data_files["unknown"], **kwargs, patch_centers=centers
        )

        (w_sp,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms, unk_rand=None
        )
        (w_ss,) = autocorrelate(config, reference, randoms)
        nz_direct = RedshiftData.from_corrfuncs(w_sp, w_ss)

        assert_array_almost_equal(nz_pipeline.data, nz_direct.data)
        assert_array_almost_equal(nz_pipeline.samples, nz_direct.samples)


class TestCommandline:
    def test_dump_template_is_valid_yaml(self, capsys):
        import yaml

        from yet_another_wizz_tpu.cli.commandline import main

        with pytest.raises(SystemExit):
            main(["--dump"])
        template = capsys.readouterr().out
        parsed = yaml.safe_load(template)
        assert set(parsed) == {"correlation", "inputs", "tasks"}

    def test_dump_template_defaults_validate(
        self, tmp_path, capsys, monkeypatch
    ):
        """The dumped defaults must form a RUNNABLE setup once the
        catalog paths exist — a self-refuting template (e.g. a default
        task whose required column is commented out) fails here."""
        import yaml

        from yet_another_wizz_tpu.cli.commandline import main
        from yet_another_wizz_tpu.cli.config import ProjectConfig
        from yet_another_wizz_tpu.cli.directory import ProjectDirectory
        from yet_another_wizz_tpu.cli.tasks import TaskList

        with pytest.raises(SystemExit):
            main(["--dump"])
        parsed = yaml.safe_load(capsys.readouterr().out)

        monkeypatch.chdir(tmp_path)
        for section in parsed["inputs"].values():
            if not isinstance(section, dict):
                continue
            for key in ("path_data", "path_rand"):
                value = section.get(key)
                if value is None:
                    continue
                paths = value.values() if isinstance(value, dict) else [value]
                for path in paths:
                    Path(path).touch()

        config = ProjectConfig.from_dict(parsed)
        project = ProjectDirectory(tmp_path / "proj", config.bin_indices)
        TaskList(project, config)  # every task's check_config passes

    def test_cli_end_to_end(self, data_files, tmp_path, capsys):
        import yaml

        from yet_another_wizz_tpu.cli.commandline import main

        setup_path = tmp_path / "setup.yml"
        with setup_path.open("w") as f:
            yaml.safe_dump(base_setup(data_files, ["hist"]), f)
        code = main(
            [str(tmp_path / "project"), str(setup_path), "--quiet"]
        )
        assert code == 0
        assert (tmp_path / "project" / "true" / "nz_true_1.dat").exists()

    def test_cli_error_reporting(self, tmp_path, capsys):
        from yet_another_wizz_tpu.cli.commandline import main

        code = main([str(tmp_path / "project"), "--quiet"])
        assert code == 1
        assert "ERROR" in capsys.readouterr().err


class TestLockFile:
    def test_concurrent_run_blocked(self, data_files, tmp_path):
        import yaml

        from yet_another_wizz_tpu.cli.pipeline import Pipeline

        setup_path = tmp_path / "setup.yml"
        with setup_path.open("w") as f:
            yaml.safe_dump(base_setup(data_files, ["hist"]), f)
        pipeline = Pipeline.create(tmp_path / "project", setup_path)
        # simulate a crashed or concurrent run holding the lock
        pipeline.project.lock_path.write_text("12345:hist")
        with pytest.raises(RuntimeError, match="lock"):
            pipeline.run()
        pipeline.project.lock_path.unlink()
        pipeline.run()  # released lock allows the run

    def test_partial_resume_runs_missing_tasks(self, data_files, tmp_path):
        run(tmp_path, base_setup(data_files, ["hist"]))
        resumed = run_setup(
            tmp_path / "project",
            setup_file=None,
            resume=True,
            quiet=True,
        )
        # hist already complete; nothing rescheduled
        assert all(task.name != "hist" for task in resumed.tasks)


class TestCacheLifecycle:
    def test_overwrite_clears_external_cache(self, data_files, tmp_path):
        """--overwrite on a project with an external (symlinked) cache
        must clear the cache contents too, or the new run silently
        reuses the old run's patch centers and catalogs."""
        setup = base_setup(data_files, ["hist"])
        setup["inputs"]["cache_path"] = str(tmp_path / "extcache")
        run(tmp_path, setup)
        stale = tmp_path / "extcache" / "patch_centers.npy"
        assert stale.exists()
        mtime = stale.stat().st_mtime_ns
        run(tmp_path, setup, overwrite=True)
        # the centers were re-derived, not reused
        assert stale.stat().st_mtime_ns != mtime

    def test_resume_reingests_truncated_cache(self, data_files, tmp_path):
        """A crash mid-ingestion leaves catalog files without the
        writers' final artifact (``patch_ids.bin``) or the pair
        sentinel; resume must re-ingest, not silently measure the
        truncated catalog."""
        pipeline = run(tmp_path, base_setup(data_files, ["hist"]))
        handle = pipeline.project.cache.unknown[1]
        assert handle.exists()
        # simulate the crash: the sentinel is written after both
        # catalogs, patch_ids.bin is each writer's final artifact
        handle._sentinel.unlink()
        (handle.data.path / "patch_ids.bin").unlink()
        assert not handle.exists()
        resumed = run_setup(
            tmp_path / "project", setup_file=None, resume=True, quiet=True
        )
        assert any(task.name == "cache_unk" for task in resumed.tasks)
        assert handle.exists()


class TestTaskOptions:
    """Tasks may carry options as single-key mappings in the YAML list."""

    def test_estimate_options(self, data_files, tmp_path):
        tasks = [
            "cross_corr",
            {"estimate": {"method": "bootstrap", "num_samples": 100,
                          "estimator": "DP"}},
        ]
        pipeline = run(tmp_path, base_setup(data_files, tasks))
        nz = pipeline.project.estimate.nz_est[1].load()
        assert nz.method == "bootstrap"
        assert nz.samples.shape[0] == 100

    def test_unknown_option_rejected(self, data_files, tmp_path):
        tasks = ["cross_corr", {"estimate": {"bogus": 1}}]
        with pytest.raises(ConfigError, match="bogus"):
            run(tmp_path, base_setup(data_files, tasks))

    def test_malformed_entry_rejected(self, data_files, tmp_path):
        tasks = [{"cross_corr": None, "estimate": None}]
        with pytest.raises(ConfigError, match="single-key"):
            run(tmp_path, base_setup(data_files, tasks))


@pytest.mark.slow
def test_profile_trace_written(data_files, tmp_path):
    pipeline = run(
        tmp_path, base_setup(data_files, ["hist"]), profile=True
    )
    trace_dir = pipeline.project.path / "profile"
    assert trace_dir.exists()
    traces = list(trace_dir.rglob("*.trace.json.gz"))
    assert traces, "no profiler trace written"


def test_task_order_is_deterministic(data_files, tmp_path):
    """cache_ref must come before cache_unk regardless of hash
    randomisation: the first cached catalog defines the kmeans patch
    centers, so unstable ordering made pipeline outputs nondeterministic
    across processes."""
    pipeline = run(tmp_path, base_setup(data_files, ["cross_corr"]))
    names = [type(task).name for task in pipeline.tasks.queue] if hasattr(
        pipeline.tasks, "queue") else []
    assert names.index("cache_ref") < names.index("cache_unk")


@pytest.mark.slow
def test_pipeline_deterministic_across_processes(data_files, tmp_path):
    """Identical setups must produce byte-identical outputs in separate
    interpreter processes (hash randomisation exposed an ordering bug
    where the kmeans patch centers came from whichever catalog cached
    first)."""
    import subprocess
    import sys

    import yaml

    setup = base_setup(data_files, ["cross_corr", "estimate"])
    setup_path = tmp_path / "setup.yml"
    with setup_path.open("w") as f:
        yaml.safe_dump(setup, f)

    outputs = []
    for run_id in (1, 2):
        wdir = tmp_path / f"proj{run_id}"
        code = (
            "import sys; sys.path.insert(0, {root!r});"
            "from yet_another_wizz_tpu.cli.pipeline import run_setup;"
            "run_setup({wdir!r}, {setup!r}, quiet=True)"
        ).format(
            root=str(Path(__file__).parent.parent),
            wdir=str(wdir),
            setup=str(setup_path),
        )
        subprocess.run(
            [sys.executable, "-c", code], check=True,
            env={
                **os.environ,
                "PYTHONHASHSEED": "random",
                "JAX_PLATFORMS": "cpu",
            },
        )
        outputs.append(
            (wdir / "estimate" / "nz_est_1.dat").read_bytes()
            + (wdir / "estimate" / "nz_est_1.smp").read_bytes()
        )
    assert outputs[0] == outputs[1]


class TestExecutionConfig:
    """Optional `execution:` section: out-of-core measurement through the
    pipeline (LazyCatalog + blocked engine)."""

    def test_lazy_blocked_pipeline_matches_default(self, data_files, tmp_path):
        import numpy as np

        tasks = ["auto_ref", "cross_corr", "estimate"]
        (tmp_path / "default").mkdir()
        (tmp_path / "lazy").mkdir()
        run(tmp_path / "default", base_setup(data_files, tasks))

        setup = base_setup(data_files, tasks)
        setup["execution"] = dict(max_resident_patches=2)
        run(tmp_path / "lazy", setup)

        for product in ("estimate/nz_est_1", "estimate/auto_ref"):
            default = np.loadtxt(
                tmp_path / f"default/project/{product}.dat"
            )
            lazy = np.loadtxt(tmp_path / f"lazy/project/{product}.dat")
            np.testing.assert_allclose(lazy, default, rtol=1e-5, atol=1e-8)

    def test_pipeline_session_cache_spans_tasks(
        self, data_files, tmp_path, monkeypatch
    ):
        """A blocked pipeline run creates exactly ONE tile cache (the
        session cache held by Pipeline.run) — the measurements adopt it
        ambiently instead of creating their own — and it serves hits, so
        blocks are genuinely shared between the count types and tasks."""
        from yet_another_wizz_tpu.correlation import blocked

        created = []
        original = blocked.measurement_tile_cache

        def spying(*args, **kwargs):
            ctx = original(*args, **kwargs)

            class Spy:
                def __enter__(self):
                    cache = ctx.__enter__()
                    created.append(cache)
                    return cache

                def __exit__(self, *exc):
                    return ctx.__exit__(*exc)

            return Spy()

        monkeypatch.setattr(blocked, "measurement_tile_cache", spying)
        # the pipeline imports it lazily from the module, so patching the
        # module attribute covers both Pipeline.run and _measurement_cache
        from yet_another_wizz_tpu.cli import pipeline as pipeline_mod  # noqa: F401

        setup = base_setup(data_files, ["auto_ref", "cross_corr", "estimate"])
        setup["execution"] = dict(max_resident_patches=2)
        run(tmp_path, setup)

        assert len(created) == 1, "measurements must adopt the session cache"
        assert created[0].hits > 0

    def test_catalog_memo_shares_instances(self, tmp_path):
        """Inside catalog_memo (held by Pipeline.run in blocked mode),
        handle loads of the same cache return the SAME object — the
        identity the session tile cache needs for cross-task block
        sharing; outside it, loads stay fresh."""
        from yet_another_wizz_tpu import Catalog
        from yet_another_wizz_tpu.cli.directory import (
            CacheHandle, catalog_memo,
        )
        from yet_another_wizz_tpu.examples import generate_mock_data

        mock = generate_mock_data(
            num_reference=300, num_unknown=1, num_randoms=1, seed=5
        )
        Catalog.from_arrays(
            **mock["reference"], degrees=False, patch_num=2,
            cache_directory=tmp_path / "pair" / "data",
        )
        handle = CacheHandle(tmp_path / "pair")
        assert handle.load_data(lazy=True) is not handle.load_data(lazy=True)
        with catalog_memo():
            memoised = handle.load_data(lazy=True)
            assert handle.load_data(lazy=True) is memoised
            # a freshly constructed handle (every project property access
            # builds one) must hit the same memo entry
            fresh = CacheHandle(tmp_path / "pair")
            assert fresh.load_data(lazy=True) is memoised
            assert handle.load_data(lazy=False) is not memoised
        assert handle.load_data(lazy=True) is not memoised

    def test_cache_pair_completeness_expects_configured_randoms(
        self, tmp_path
    ):
        """A pair whose setup configures randoms is incomplete while the
        rand cache is missing — even when a stale pair sentinel survives a
        crash inside the overwrite window — so resume re-ingests instead
        of silently running without randoms."""
        import shutil

        from yet_another_wizz_tpu import Catalog
        from yet_another_wizz_tpu.cli.directory import CacheHandle
        from yet_another_wizz_tpu.examples import generate_mock_data

        mock = generate_mock_data(
            num_reference=300, num_unknown=1, num_randoms=300, seed=7
        )
        handle = CacheHandle(tmp_path / "pair")
        Catalog.from_arrays(
            **mock["reference"], degrees=False, patch_num=2,
            cache_directory=handle.data.path,
        )
        # adopted data-only cache: complete unless randoms are expected
        assert handle.exists()
        assert handle.exists(expect_rand=False)
        assert not handle.exists(expect_rand=True)

        Catalog.from_arrays(
            **mock["randoms"], degrees=False, patch_num=2,
            cache_directory=handle.rand.path,
        )
        assert handle.exists(expect_rand=True)
        handle.mark_complete()

        # crash window: overwrite deleted the old rand cache, the new one
        # never landed; the stale sentinel must not mask the loss
        shutil.rmtree(handle.rand.path)
        assert not handle.exists(expect_rand=True)
        assert handle.exists(expect_rand=False)
        handle.clear_complete()
        assert not handle._sentinel.exists()
        handle.clear_complete()  # idempotent

    def test_execution_round_trips_through_pipeline_yml(
        self, data_files, tmp_path
    ):
        from yet_another_wizz_tpu.cli.config import ProjectConfig

        setup = base_setup(data_files, ["cross_corr", "estimate"])
        setup["execution"] = dict(max_resident_patches=3, lazy=False)
        config = ProjectConfig.from_dict(setup)
        assert config.execution.max_resident_patches == 3
        assert config.execution.lazy is False
        restored = ProjectConfig.from_dict(config.to_dict())
        assert restored.execution.max_resident_patches == 3

    def test_invalid_execution_rejected(self, data_files, tmp_path):
        from yet_another_wizz_tpu.cli.config import ProjectConfig
        from yet_another_wizz_tpu.config.base import ConfigError

        setup = base_setup(data_files, ["cross_corr", "estimate"])
        setup["execution"] = dict(max_resident_patches=0)
        with pytest.raises(ConfigError, match="execution.max_resident"):
            ProjectConfig.from_dict(setup)
        setup["execution"] = dict(lazy=True)
        with pytest.raises(ConfigError, match="execution.lazy"):
            ProjectConfig.from_dict(setup)
        setup["execution"] = dict(bogus=1)
        with pytest.raises(ConfigError, match="bogus"):
            ProjectConfig.from_dict(setup)


class TestExecutionDevices:
    """`execution: devices/data_sharding/audit`: the pipeline runs its
    measurements on a device mesh (VERDICT r2 item 1)."""

    def test_devices_knob_round_trips(self, data_files):
        from yet_another_wizz_tpu.cli.config import ProjectConfig

        setup = base_setup(data_files, ["cross_corr", "estimate"])
        setup["execution"] = dict(
            devices=8, data_sharding="columns", audit=True
        )
        config = ProjectConfig.from_dict(setup)
        assert config.execution.devices == 8
        assert config.execution.data_sharding == "columns"
        assert config.execution.audit is True
        restored = ProjectConfig.from_dict(config.to_dict())
        assert restored.execution.devices == 8
        assert restored.execution.data_sharding == "columns"
        assert restored.execution.audit is True

    def test_invalid_devices_rejected(self, data_files):
        from yet_another_wizz_tpu.cli.config import ProjectConfig

        setup = base_setup(data_files, ["cross_corr", "estimate"])
        setup["execution"] = dict(devices=0)
        with pytest.raises(ConfigError, match="execution.devices"):
            ProjectConfig.from_dict(setup)
        setup["execution"] = dict(data_sharding="rows")
        with pytest.raises(ConfigError, match="execution.data_sharding"):
            ProjectConfig.from_dict(setup)
        # audit composes with the blocked path (per-block repair)
        setup["execution"] = dict(audit=True, max_resident_patches=2)
        config = ProjectConfig.from_dict(setup)
        assert config.execution.audit
        assert config.execution.max_resident_patches == 2

    def test_measurement_kwargs_mesh_resolution(self):
        from yet_another_wizz_tpu.cli.config import ExecutionConfig

        auto = ExecutionConfig().measurement_kwargs()
        assert auto["mesh"] is None  # automatic pool detection
        single = ExecutionConfig(devices=1).measurement_kwargs()
        assert single["mesh"] == "single"
        eight = ExecutionConfig(devices=8).measurement_kwargs()
        assert eight["mesh"].devices.size == 8

    def test_pipeline_on_device_mesh_matches_default(
        self, data_files, tmp_path, monkeypatch
    ):
        """A pipeline with `devices: 8` runs every measurement sharded
        over the full virtual mesh and reproduces the single-device
        products."""
        import yet_another_wizz_tpu.parallel as parallel

        tasks = ["auto_ref", "cross_corr", "estimate"]
        (tmp_path / "default").mkdir()
        (tmp_path / "meshed").mkdir()
        run(tmp_path / "default", base_setup(data_files, tasks))

        meshes = []
        real = parallel.count_pairs_sharded

        def recorder(*args, **kwargs):
            meshes.append(kwargs.get("mesh"))
            return real(*args, **kwargs)

        monkeypatch.setattr(parallel, "count_pairs_sharded", recorder)
        setup = base_setup(data_files, tasks)
        setup["execution"] = dict(devices=8)
        run(tmp_path / "meshed", setup)

        assert meshes and all(m.devices.size == 8 for m in meshes)
        for product in ("estimate/nz_est_1", "estimate/auto_ref"):
            default = np.loadtxt(tmp_path / f"default/project/{product}.dat")
            meshed = np.loadtxt(tmp_path / f"meshed/project/{product}.dat")
            np.testing.assert_allclose(meshed, default, rtol=1e-4, atol=1e-8)
