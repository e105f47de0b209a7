"""The kernels' build cache (``ctrl_sim_tpu_torch/ops/build.py``): a
library's name follows its source and every shared header under ``csrc/``,
so an edited header rebuilds each library that may include it and nothing
stale is loaded. Runs without nvcc: it only names the libraries."""

import shutil

import pytest

from ctrl_sim_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


def test_sources_and_headers_exist():
    for source in build.SOURCES:
        assert (build.CSRC_DIR / source).is_file()
    headers = {p.name for p in build.CSRC_DIR.glob("*.cuh")}
    assert {"mma_sm90.cuh", "decode_mma.cuh", "wgmma_sm90.cuh"} <= headers
    for source in build.SOURCES:
        text = (build.CSRC_DIR / source).read_text()
        assert any(f'#include "{h}"' in text for h in headers), source


@pytest.mark.parametrize("header", ["mma_sm90.cuh", "decode_mma.cuh", "wgmma_sm90.cuh"])
def test_library_path_follows_included_headers(csrc, header):
    before = {s: build.library_path(s) for s in build.SOURCES}
    assert before == {s: build.library_path(s) for s in build.SOURCES}  # stable while nothing changes
    path = csrc / header
    original = path.read_text()
    path.write_text(original + "\n// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert all(after[s] != before[s] for s in build.SOURCES)
    assert all(after[s].parent == build.BUILD_DIR and after[s].name.startswith(s[:-3] + "_") for s in build.SOURCES)
    path.write_text(original)
    assert before == {s: build.library_path(s) for s in build.SOURCES}


def test_library_path_follows_its_own_source_only(csrc):
    before = {s: build.library_path(s) for s in build.SOURCES}
    (csrc / "decode_attention_q8.cu").write_text((csrc / "decode_attention_q8.cu").read_text() + "\n// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert after["decode_attention_q8.cu"] != before["decode_attention_q8.cu"]
    assert after["decode_attention.cu"] == before["decode_attention.cu"]
    assert after["flash_attention.cu"] == before["flash_attention.cu"]
