"""Host-side behaviour of ``chip_smoke.py``: it refuses to run without a
GPU, parses its options and prints the exact result line."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def test_refuses_the_cpu(capsys):
    """No CPU fallback: a non-zero exit, a message, and no result line."""
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "no GPU found" in err
    assert '"ok"' not in out


def test_require_gpu_names_the_backend():
    import jax

    with pytest.raises(chip_smoke.SmokeFailure, match="'cpu'"):
        chip_smoke.require_gpu(jax)


@pytest.mark.parametrize("argv,devices", [([], 1), (["--devices", "4"], 4)])
def test_parses_devices(argv, devices):
    assert chip_smoke.parse_args(argv).devices == devices


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--devices", "x"]])
def test_rejects_other_device_counts(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_result_line_format():
    class FakeDevice:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([FakeDevice()] * 4)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}'
    )
    assert json.loads(line)["device"]["count"] == 4


def test_max_rel_and_gate():
    assert chip_smoke.max_rel([1.0, 2.0, 0.0], [1.0, 2.0, 0.0]) == 0.0
    assert chip_smoke.max_rel([1.1, 0.0], [1.0, 0.0]) == pytest.approx(0.1)
    # a count where the reference has none is an infinite deviation
    assert chip_smoke.max_rel([0.0, 1.0], [1.0, 0.0]) == float("inf")
    with pytest.raises(chip_smoke.SmokeFailure, match="too far"):
        chip_smoke.check(False, "too far")
