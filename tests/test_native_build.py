"""The native library is built only from the committed source: its file
name carries the source's hash, so a stale or foreign ``.so`` in the tree
is never loaded."""

from pathlib import Path

from yet_another_wizz_tpu import _native


def test_library_named_by_source_hash(tmp_path):
    source = tmp_path / "tilepack.cpp"
    source.write_text("int a;\n")
    first = _native.library_path(source)
    assert first.parent == tmp_path / "build"
    source.write_text("int b;\n")
    assert _native.library_path(source) != first
    source.write_text("int a;\n")
    assert _native.library_path(source) == first


def test_stray_library_is_ignored(tmp_path, monkeypatch):
    """A library lying next to the source, newer than it, is not used:
    the loader asks for the hash-named file and builds it when absent."""
    source = tmp_path / "tilepack.cpp"
    source.write_text("int a;\n")
    (tmp_path / "libtilepack.so").write_bytes(b"not a library")
    built = []

    def fake_build(library):
        built.append(library)
        return False  # as if no compiler were available

    monkeypatch.setattr(_native, "_SOURCE", source)
    monkeypatch.setattr(_native, "_build_library", fake_build)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "NATIVE_ENABLED", False)
    _native._load()
    assert built == [_native.library_path(source)]
    assert _native._lib is None and not _native.NATIVE_ENABLED


def test_loaded_library_matches_current_source():
    if not _native.NATIVE_ENABLED:
        return  # nothing loaded: the numpy fallbacks are in use
    assert Path(_native._lib._name) == _native.library_path()
