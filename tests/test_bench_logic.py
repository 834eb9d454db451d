"""Host-side logic of the benchmark harness (no device required): record
emission, phase attribution and the device check."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


class TestEmitRecord:
    """The emitted stdout line is the benchmark's result, so emission
    must be parse-proof against every value a live run can produce."""

    def test_nan_and_inf_become_null(self, tmp_path):
        import json

        import numpy as np

        record = {
            "value": float("nan"),
            "nested": {"hi": float("inf"), "lo": float("-inf")},
            "list": [1.0, float("nan"), "ok"],
        }
        line = bench.emit_record(
            record, full_record_path=str(tmp_path / "full.json")
        )
        parsed = json.loads(line, parse_constant=bench._reject_constant)
        assert parsed["value"] is None
        assert parsed["nested"] == {"hi": None, "lo": None}
        assert parsed["list"] == [1.0, None, "ok"]
        # the full committed record is strict too
        with open(tmp_path / "full.json") as f:
            json.loads(f.read(), parse_constant=bench._reject_constant)

    def test_numpy_scalars_and_arrays(self):
        import json

        import numpy as np

        record = {
            "f32": np.float32(1.5),
            "i64": np.int64(7),
            "flag": np.bool_(True),
            "arr": np.array([1.0, np.nan, 3.0]),
            "key_is_int": {np.int32(3): "x"},
        }
        parsed = json.loads(
            bench.emit_record(record),
            parse_constant=bench._reject_constant,
        )
        assert parsed["f32"] == 1.5
        assert parsed["i64"] == 7
        assert parsed["flag"] is True
        assert parsed["arr"] == [1.0, None, 3.0]
        assert parsed["key_is_int"] == {"3": "x"}

    def test_full_record_survives_driver_loss(self, tmp_path):
        """The full record also lands on disk."""
        import json

        path = tmp_path / "BENCH_record.json"
        bench.emit_record({"metric": "m", "value": 1.0}, str(path))
        assert json.loads(path.read_text())["metric"] == "m"


class TestPerRunPhases:
    def test_setup_is_wall_not_covered_by_blocked_clock(self):
        totals = {
            "rows": 2.0, "cols": 4.0, "drain": 6.0, "drain_wait": 5.0,
            "queue": 1.0, "corr_wall": 20.0, "post": 0.4,
            "num_block_pairs": 42, "candidate_pairs": 1e9,
        }
        phases = bench.per_run_phases(totals, num_runs=2)
        # counters dropped, sub-phases kept, everything halved
        assert "num_block_pairs" not in phases
        assert "candidate_pairs" not in phases
        assert phases["drain_wait"] == 2.5
        assert phases["post"] == 0.2
        # setup = corr_wall/run minus top-level blocked phases
        # (10.0 - (1.0 + 2.0 + 3.0 + 0.5)) — drain_wait nests in drain
        assert phases["setup"] == pytest.approx(3.5)

    def test_setup_clamped_at_zero_and_zero_runs_safe(self):
        totals = {"drain": 5.0, "corr_wall": 1.0}
        phases = bench.per_run_phases(totals, num_runs=0)
        assert phases["setup"] == 0.0
        assert phases["drain"] == 5.0


class TestDevice:
    def test_refuses_without_gpu(self):
        """No CPU fallback: the benchmark measures the GPU only."""
        import jax

        assert jax.default_backend() == "cpu"
        with pytest.raises(SystemExit, match="no GPU found"):
            bench.require_gpu(jax)

    def test_record_names_the_device(self, monkeypatch):
        import jax

        class FakeDevice:
            platform = "gpu"
            device_kind = "NVIDIA H100 80GB HBM3"

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(jax, "devices", lambda: [FakeDevice()] * 4)
        assert bench.require_gpu(jax) == {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
        }
