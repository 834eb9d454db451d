#!/usr/bin/env python3
"""Generate the markdown API reference from the package's docstrings.

Walks the public surface (top-level ``__all__`` plus the documented
submodules) and emits one markdown file per module under ``docs/api/``,
with signatures and docstrings for every public class, method, property
and function. ``tests/test_docs_api.py`` regenerates the files and fails
if they are stale or if any public symbol is missing.

Run: ``JAX_PLATFORMS=cpu python scripts/gen_api_docs.py``
"""

from __future__ import annotations

import inspect
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# module path -> (title, blurb)
MODULES = {
    "yet_another_wizz_tpu": (
        "Top-level package",
        "Everything most users need, re-exported at the package root "
        "(`import yet_another_wizz_tpu as yawt`).",
    ),
    "yet_another_wizz_tpu.catalog": (
        "Catalogs and ingestion",
        "Patch-resolved point catalogs, chunked file readers and the "
        "streaming ingestion pipeline.",
    ),
    "yet_another_wizz_tpu.correlation": (
        "Correlation engine",
        "Measurement entry points, pair-count containers, correlation "
        "functions and sampled data.",
    ),
    "yet_another_wizz_tpu.config": (
        "Configuration",
        "Declarative, YAML-serialisable measurement configuration.",
    ),
    "yet_another_wizz_tpu.cosmology": (
        "Cosmology and scales",
        "Self-contained FLRW cosmology, scale containers and redshift "
        "binning generators.",
    ),
    "yet_another_wizz_tpu.coordinates": (
        "Coordinates",
        "Angular coordinate and distance containers with unit-sphere "
        "conversions.",
    ),
    "yet_another_wizz_tpu.binning": (
        "Binning",
        "Redshift bin edges with closed-left/right semantics.",
    ),
    "yet_another_wizz_tpu.options": (
        "Options",
        "String enums for all fixed-choice parameters.",
    ),
    "yet_another_wizz_tpu.randoms": (
        "Random generators",
        "Uniform sky randoms from box limits or HEALPix maps.",
    ),
    "yet_another_wizz_tpu.redshifts": (
        "Redshift products",
        "Clustering-redshift estimates and redshift histograms.",
    ),
    "yet_another_wizz_tpu.ops": (
        "Compute core",
        "Device tiles, linkage, angular edges and the pair-count kernels "
        "(Pallas / XLA / float64 oracle).",
    ),
    "yet_another_wizz_tpu.parallel": (
        "Parallel runtime",
        "Device-mesh sharding of the tile-pair grid and multi-host (pod) "
        "coordination.",
    ),
    "yet_another_wizz_tpu.models.estimators": (
        "Estimators",
        "Correlation estimators (Davis-Peebles, Landy-Szalay, scalar).",
    ),
    "yet_another_wizz_tpu.examples": (
        "Examples",
        "2dFLenS example data (when available) or a deterministic mock "
        "survey, with precomputed correlation products.",
    ),
    "yet_another_wizz_tpu.utils.plotting": (
        "Plotting",
        "Optional matplotlib helpers for sampled data and correlation "
        "matrices.",
    ),
    "yet_another_wizz_tpu.utils.logging": (
        "Logging and progress",
        "Logger configuration, progress indicator and profiling helpers.",
    ),
    "yet_another_wizz_tpu.cli": (
        "Pipeline / CLI",
        "The yaw_cli batch tool: YAML setups, task DAG, project directory.",
    ),
}


def public_names(module) -> list[str]:
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")]
    return list(names)


def format_signature(name: str, obj) -> str:
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return name
    text = f"{name}{sig}"
    if len(text) > 88:
        params = ", ".join(
            str(p) for p in sig.parameters.values()
        )
        ret = (
            f" -> {sig.return_annotation}"
            if sig.return_annotation not in (inspect.Signature.empty,)
            else ""
        )
        text = f"{name}(\n    " + ",\n    ".join(
            str(p) for p in sig.parameters.values()
        ) + f"\n){ret}" if params else text
    return text


def clean_doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else ""


def first_line(obj) -> str:
    """First sentence of the docstring (whole first paragraph joined, cut
    at the first sentence end — a physical line break must not truncate
    the summary mid-sentence)."""
    doc = clean_doc(obj)
    if not doc:
        return ""
    paragraph = " ".join(
        line.strip() for line in doc.split("\n\n")[0].splitlines()
    )
    for stop in (". ", ".\t"):
        if stop in paragraph:
            return paragraph[: paragraph.index(stop) + 1]
    return paragraph


def document_class(name: str, cls) -> list[str]:
    out = [f"### `{name}`", ""]
    if issubclass(cls, BaseException):
        out.append(f"Exception. {first_line(cls)}")
        out.append("")
        return out

    import enum

    doc = clean_doc(cls)
    if doc:
        out += [doc, ""]

    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        out.append("Members: " + ", ".join(f"`{m.name}`" for m in cls))
        out.append("")
        return out

    # constructor signature (skip for enums / exceptions)
    init = cls.__dict__.get("__init__")
    if init is not None and clean_doc(init) != clean_doc(object.__init__):
        out += [
            "```python",
            format_signature(name, cls),
            "```",
            "",
        ]

    # own members plus public API inherited from bases defined in this
    # package (e.g. BaseConfig.from_file/to_file) — external bases like
    # object or ABC contribute nothing
    collected: dict[str, object] = {}
    for klass in cls.__mro__:
        if klass.__module__.partition(".")[0] != cls.__module__.partition(".")[0]:
            continue
        for attr_name, attr in vars(klass).items():
            if not attr_name.startswith("_") and attr_name not in collected:
                collected[attr_name] = attr
    members = sorted(collected.items())
    rows = []
    for attr_name, attr in members:
        if isinstance(attr, property):
            kind = "property"
            target = attr.fget
        elif isinstance(attr, (classmethod, staticmethod)):
            kind = "classmethod" if isinstance(attr, classmethod) else "staticmethod"
            target = attr.__func__
        elif inspect.isfunction(attr):
            kind = "method"
            target = attr
        else:
            continue
        summary = first_line(target)
        if kind == "property":
            rows.append(f"- `{attr_name}` (property) — {summary}")
        else:
            try:
                sig = inspect.signature(target)
                params = [
                    str(p)
                    for key, p in sig.parameters.items()
                    if key not in ("self", "cls")
                ]
                sig_text = f"({', '.join(params)})"
                if len(sig_text) > 70:
                    sig_text = "(...)"
            except (ValueError, TypeError):
                sig_text = "(...)"
            rows.append(f"- `{attr_name}{sig_text}` — {summary}")
    if rows:
        out += rows + [""]
    return out


def document_function(name: str, func) -> list[str]:
    out = [f"### `{name}`", ""]
    out += [
        "```python",
        format_signature(name, func),
        "```",
        "",
    ]
    doc = clean_doc(func)
    if doc:
        out += [doc, ""]
    return out


def document_value(name: str, value, module) -> list[str]:
    out = [f"### `{name}`", ""]
    type_name = type(value).__name__
    # module-level constants: show repr for simple values; suppress default
    # object reprs (memory addresses are not reproducible)
    rep = repr(value)
    if len(rep) > 100 or " at 0x" in rep:
        rep = f"<{type_name}>"
    out += [f"Constant (`{type_name}`): `{rep}`", ""]
    return out


def render_module(path: str, title: str, blurb: str) -> str:
    import importlib

    module = importlib.import_module(path)
    lines = [
        "<!-- generated by scripts/gen_api_docs.py; do not edit by hand -->",
        "",
        f"# {title} (`{path}`)",
        "",
        blurb,
        "",
    ]
    mod_doc = clean_doc(module)
    if mod_doc:
        lines += [mod_doc, ""]

    for name in public_names(module):
        obj = getattr(module, name)
        if inspect.ismodule(obj):
            continue
        if inspect.isclass(obj):
            lines += document_class(name, obj)
        elif callable(obj):
            lines += document_function(name, obj)
        else:
            lines += document_value(name, obj, module)
    return "\n".join(lines).rstrip() + "\n"


def generate(out_dir: Path) -> dict[str, str]:
    files = {}
    index = [
        "<!-- generated by scripts/gen_api_docs.py; do not edit by hand -->",
        "",
        "# API reference",
        "",
        "Generated from the package docstrings "
        "(`python scripts/gen_api_docs.py`).",
        "",
    ]
    for path, (title, blurb) in MODULES.items():
        stem = path.replace("yet_another_wizz_tpu", "yawt").replace(".", "_")
        files[f"{stem}.md"] = render_module(path, title, blurb)
        index.append(f"- [{title}]({stem}.md) — `{path}`")
    files["index.md"] = "\n".join(index) + "\n"

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, content in files.items():
        (out_dir / name).write_text(content)
    return files


if __name__ == "__main__":
    out = REPO / "docs" / "api"
    files = generate(out)
    total = sum(len(c.splitlines()) for c in files.values())
    print(f"wrote {len(files)} files ({total} lines) to {out}")
