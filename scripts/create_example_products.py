#!/usr/bin/env python3
"""Regenerate the committed mock example products.

The package ships precomputed correlation products of the deterministic
mock example (``yet_another_wizz_tpu/examples/products/``: cross.hdf,
auto.hdf, estimate.{dat,smp,cov}) so a fresh offline install can load
``examples.cross/auto/estimate`` without measuring — the counterpart of
the reference's committed 2dFLenS products and its regeneration script
(/root/reference/src/yaw/examples/__init__.py:46-301,
/root/reference/create_example_data.py). Products are computed with the
portable XLA engine on CPU so they are bit-stable across machines; the
golden regression test (tests/test_golden_example.py) pins the same
numbers.

Run: python scripts/create_example_products.py
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["YAWT_EXAMPLE_FORCE_MOCK"] = "1"
os.environ["YAWT_EXAMPLE_IGNORE_PACKAGED"] = "1"

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["YAWT_EXAMPLE_CACHE"] = tmp

        import yet_another_wizz_tpu.examples as examples

        examples._refresh_paths()
        assert not examples.USES_REAL_DATA
        examples.ExampleData.build_products(force=True)

        target = REPO / "yet_another_wizz_tpu" / "examples" / "products"
        target.mkdir(exist_ok=True)
        names = [
            "cross.hdf", "auto.hdf",
            "estimate.dat", "estimate.smp", "estimate.cov",
        ]
        for name in names:
            shutil.copy2(Path(tmp) / name, target / name)
            print(f"wrote {target / name}")


if __name__ == "__main__":
    main()
