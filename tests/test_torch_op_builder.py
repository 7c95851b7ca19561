"""The port's kernel builder names each library by a digest of nvcc's flags,
the kernel source and every ``csrc/*.cuh`` header. These tests change
files in a temporary copy of ``csrc/`` and check which edits give a new
library name, so a header edited after a build never reuses the stale
library; they need no ``nvcc``.
"""

import shutil

import pytest

from deepspeed_tpu_torch.ops import op_builder


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(op_builder.CSRC, dst)
    return dst


def test_sources_include_the_shared_hopper_header():
    # directly, or through attn_fwd.cuh (the attention forward's mainloop,
    # shared by the two attention files)
    def text(name):
        return (op_builder.CSRC / name).read_text()
    for name in ("fused_collectives.cu", "attn_fwd.cuh"):
        assert '#include "hopper.cuh"' in text(name), name
    for name in ("flash_attention.cu", "paged_attention.cu"):
        assert '#include "attn_fwd.cuh"' in text(name), name
    assert (op_builder.CSRC / "hopper.cuh").is_file()


def test_digest_is_stable_and_follows_flags(csrc):
    a = op_builder.source_digest("flash_attention", (), csrc)
    assert a == op_builder.source_digest("flash_attention", (), csrc)
    assert a == op_builder.source_digest("flash_attention")
    assert a != op_builder.source_digest("flash_attention", ("-DX=1",), csrc)
    assert a != op_builder.source_digest("fused_collectives", (), csrc)


@pytest.mark.parametrize("edit", ["header", "new-header", "source"])
def test_digest_changes_when_a_header_or_the_source_changes(csrc, edit):
    before = {n: op_builder.source_digest(n, (), csrc)
              for n in ("flash_attention", "fused_collectives", "quant")}
    if edit == "header":
        with open(csrc / "hopper.cuh", "a") as f:
            f.write("// edited\n")
    elif edit == "new-header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        with open(csrc / "flash_attention.cu", "a") as f:
            f.write("// edited\n")
    after = {n: op_builder.source_digest(n, (), csrc) for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    # a header may be included by any source: every library is rebuilt;
    # a source edit renames only its own library
    changed = {n for n in before if after[n] != before[n]}
    if edit == "source":
        assert changed == {"flash_attention"}
    else:
        assert changed == set(before)


def test_digest_ignores_other_files(csrc):
    before = op_builder.source_digest("flash_attention", (), csrc)
    (csrc / "notes.txt").write_text("not a header\n")
    with open(csrc / "quant.cu", "a") as f:
        f.write("// edited\n")
    assert op_builder.source_digest("flash_attention", (), csrc) == before
