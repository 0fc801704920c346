"""The port's kernel build (``ops/build.py``): a library is named after the
hash of its source and of every header the source includes from ``csrc/``,
so a header change builds a new library instead of loading a stale one. Runs
without nvcc: only the names are computed."""

import shutil

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import build


def test_sources_of_follow_the_includes():
    names = {name: [p.name for p in build.sources_of(name)]
             for name in ("mi_joint", "mi_fused", "rotate")}
    assert names == {"mi_joint": ["mi_joint.cu", "joint_core.cuh"],
                     "mi_fused": ["mi_fused.cu", "joint_core.cuh"],
                     "rotate": ["rotate.cu"]}


def test_a_header_change_changes_the_library_path(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.SOURCE_DIR, csrc)
    monkeypatch.setattr(build, "SOURCE_DIR", csrc)
    names = ("mi_joint", "mi_fused", "rotate")
    before = {name: build.library_path(name) for name in names}
    assert before == {name: build.library_path(name) for name in names}  # a pure function
    header = csrc / "joint_core.cuh"
    header.write_bytes(header.read_bytes().replace(b"FW_STAGES = 6", b"FW_STAGES = 4"))
    after = {name: build.library_path(name) for name in names}
    assert after["mi_joint"] != before["mi_joint"]
    assert after["mi_fused"] != before["mi_fused"]
    assert after["rotate"] == before["rotate"]
