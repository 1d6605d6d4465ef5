"""The key a kernel's build is stored under: a hash of its source, of every
header the source includes with quotes (recursively) and of its flags, so
that an edit to a shared header rebuilds every source that includes it.
Nothing here compiles."""

import pytest

pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    src, hdr, inner = (tmp_path / n for n in ("k.cu", "common.cuh", "inner.cuh"))
    inner.write_text("int b;\n")
    hdr.write_text('#pragma once\n#include "inner.cuh"\nint a;\n')
    src.write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n'
                   '  #  include "common.cuh"\nint main;\n')
    monkeypatch.setitem(K.SOURCES, "probe", src)
    key = K._target("probe")
    assert key.parent == K.BUILD_DIR and key.name.startswith("probe-")
    assert K._target("probe") == key                  # stable
    for path, edit in ((inner, "int c;\n"), (hdr, '#include "inner.cuh"\n'),
                       (src, '#include "common.cuh"\nint other;\n')):
        before = path.read_text()
        path.write_text(edit)
        assert K._target("probe") != key, path.name   # any file of the tree
        path.write_text(before)
        assert K._target("probe") == key
    monkeypatch.setitem(K.EXTRA_FLAGS, "probe", ("-lineinfo",))
    assert K._target("probe") != key                  # and the flags


def test_flash_sources_hash_the_shared_header():
    """Both attention sources include ``flash_common.cuh``; a header that
    includes itself, or one that is missing, is read at most once."""
    header = K.SOURCES["flash_attention"].parent / "flash_common.cuh"
    body = header.read_bytes()
    for name in ("flash_attention", "flash_attention_bwd"):
        data = K._source_bytes(K.SOURCES[name])
        assert data.startswith(K.SOURCES[name].read_bytes())
        assert data.count(body) == 1
    assert K._source_bytes(K.SOURCES["fused_rmsnorm_bwd"]) == \
        K.SOURCES["fused_rmsnorm_bwd"].read_bytes()


def test_build_key_tolerates_cycles_and_missing_headers(tmp_path, monkeypatch):
    a, b = tmp_path / "a.cuh", tmp_path / "b.cuh"
    a.write_text('#include "b.cuh"\n#include "gone.cuh"\n')
    b.write_text('#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "a.cuh"\n')
    monkeypatch.setitem(K.SOURCES, "probe", src)
    assert K._source_bytes(src) == src.read_bytes() + a.read_bytes() + \
        b.read_bytes()
    assert K._target("probe").name.startswith("probe-")
