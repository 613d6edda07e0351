"""The card tools that rebuild a kernel source with text edits
(horovod_tpu_torch/tools/*_variants.py and tools/tf32_chains.py): every
edit names text that its csrc/ file holds, so a renamed or reworded
constant fails here, on the CPU, and not first on the card. The tools
themselves run on the card only; importing them runs nothing."""

import importlib
import os

import pytest

from horovod_tpu_torch import _cuda

TOOLS_DIR = os.path.join(os.path.dirname(_cuda.CSRC_DIR), "tools")
VARIANT_TOOLS = sorted(name[:-3] for name in os.listdir(TOOLS_DIR)
                       if name.endswith("_variants.py"))


def _tool(name):
    return importlib.import_module(f"horovod_tpu_torch.tools.{name}")


def _source(name):
    with open(os.path.join(_cuda.CSRC_DIR, name)) as fh:
        return fh.read()


def _edits(tool):
    """[(source file, text of the package's source, the variant's text)]
    of every variant: VARIANTS as {name: (source, edits)} or, with the
    module's one SOURCE, {name: edits}."""
    out = []
    for spec in tool.VARIANTS.values():
        source, edits = (spec if isinstance(spec, tuple)
                         else (tool.SOURCE, spec))
        out += [(source, old, new) for old, new in edits]
    return out


def test_every_variant_tool_is_found():
    assert {"bwd_tf32_variants", "dkv_variants", "dq_variants",
            "fwd_sm90_variants", "fwd_tf32_variants",
            "narrow_bwd_tf32_variants", "narrow_tf32_variants",
            "narrow_variants"} <= set(VARIANT_TOOLS)


@pytest.mark.parametrize("name", VARIANT_TOOLS)
def test_variant_edits_name_text_of_their_sources(name):
    edits = _edits(_tool(name))
    assert edits
    for source, old, new in edits:
        src = _source(source)
        assert src.count(old) == 1, (source, old)
        assert old != new and new not in src, (source, new)


def test_tf32_chains_edit_names_text_of_its_source():
    tool = _tool("tf32_chains")
    old, new = tool.EDIT
    src = _source(tool.SOURCE)
    assert src.count(old) == 1 and new not in src


def test_fwd_tf32_variants_cover_the_designs_they_name():
    """The forward's tool rebuilds the design before the wide build
    (128-column parts at every D, b h fastest) and each choice apart."""
    tool = _tool("fwd_tf32_variants")
    assert sorted(tool.VARIANTS["128cols_bh_fastest"][1]) == sorted(
        [tool.NO_WIDE, tool.BH_FASTEST])
    assert set(tool.SAME_SUMS) <= set(tool.VARIANTS)


def test_fwd_sm90_trace_marks_name_text_of_their_source():
    tool = _tool("fwd_sm90_variants")
    src = _source(tool.SOURCE)
    for old, new in tool.TRACE:
        assert src.count(old) == 1 and new not in src, old


def test_fwd_sm90_serial_variant_turns_off_every_piece():
    """The sm90 forward's pieces are the constants of one block of its
    source; the ``serial`` variant turns off each of them, and each has a
    variant that turns it off alone."""
    tool = _tool("fwd_sm90_variants")
    src = _source(tool.SOURCE)
    block = src.split("// The pieces of the overlapped loop (header).\n")[1]
    block = block.split("\n\n")[0]
    pieces = [line for line in block.splitlines()
              if line.startswith("constexpr ")]
    assert len(pieces) == 4
    serial = dict(tool.VARIANTS["serial"])
    assert sorted(serial) == sorted(pieces)
    for line in pieces:
        assert [(line, serial[line])] in tool.VARIANTS.values()


def test_narrow_tf32_variants_edit_the_narrow_tf32_forward():
    """The narrow tf32 forward's tool rebuilds
    csrc/flash_fwd_tf32_narrow_sm90.cu alone, through its own C entry,
    with one warpgroup among its variants, and the variants it requires to
    keep the package's sums (the ring's depth) are among those it
    builds."""
    tool = _tool("narrow_tf32_variants")
    assert tool.SOURCE == "flash_fwd_tf32_narrow_sm90.cu"
    assert tool.ENTRIES == {tool.SOURCE: "hvdt_flash_fwd_tf32_narrow"}
    assert tool.ENTRIES[tool.SOURCE] in _cuda._SIGNATURES
    assert tool.VARIANTS["split1"] == [tool.SPLIT1]
    assert tool.SPLIT1[1] == "kNarrowSplit = 1;"
    assert set(tool.SAME_SUMS) <= set(tool.VARIANTS)
    for name in tool.SAME_SUMS:
        assert all(edit in (tool.STAGES2, tool.STAGES4)
                   for edit in tool.VARIANTS[name])


def test_narrow_bwd_tf32_variants_edit_the_narrow_tf32_backward():
    """The narrow tf32 dq and dk/dv's tool rebuilds
    csrc/flash_bwd_tf32_narrow_sm90.cu alone, through its own C entries,
    with one warpgroup for each kernel among its variants; a variant
    named for one kernel edits that kernel's constants alone, and those it
    requires to keep the package's sums change a ring's depth alone."""
    tool = _tool("narrow_bwd_tf32_variants")
    assert tool.SOURCE == "flash_bwd_tf32_narrow_sm90.cu"
    assert tool.ENTRIES == {tool.SOURCE: "hvdt_flash_dq_tf32_narrow"}
    for entry in (tool.ENTRIES[tool.SOURCE], tool.DKV_ENTRY):
        assert entry in _cuda._SIGNATURES
    assert tool.VARIANTS["dq_split1"] == [tool.DQ_SPLIT1]
    assert tool.VARIANTS["dkv_split1"] == [tool.DKV_SPLIT1]
    assert tool.DQ_SPLIT1[1] == "kDqSplit = 1;"
    assert tool.DKV_SPLIT1[1] == "kDkvSplit = 1;"
    for name, edits in tool.VARIANTS.items():
        for kern, prefix in (("dq", "kDq"), ("dkv", "kDkv")):
            if tool.kernels_of(name) == (kern,):
                assert all(old.startswith(prefix) for old, _ in edits), name
    assert set(tool.SAME_SUMS) <= set(tool.VARIANTS)
    for name in tool.SAME_SUMS:
        assert all(edit in (tool.DQ_STAGES1, tool.DKV_STAGES1)
                   for edit in tool.VARIANTS[name])


def test_bwd_tf32_variants_cover_the_dq_designs():
    """The tf32 backward's tool rebuilds the dq design before the wide
    build (``dq_128cols``: no wide dq), the wide dq from a later head dim
    and its grid one head at a time; a ``dq_`` variant edits only dq's
    constants and is timed on dq alone, and the tool reads dq from each
    variant's library through the entry the bindings declare."""
    tool = _tool("bwd_tf32_variants")
    assert tool.VARIANTS["dq_128cols"] == (tool.SOURCE, [tool.NO_WIDE_DQ])
    assert tool.VARIANTS["dq_wide_from_256"] == (tool.SOURCE,
                                                 [tool.DQ_WIDE_FROM_256])
    assert tool.VARIANTS["dq_wide_from_64"] == (tool.SOURCE,
                                                [tool.DQ_WIDE_FROM_64])
    assert tool.NO_WIDE_DQ[0] == tool.DQ_WIDE_FROM_256[0] == \
        tool.DQ_WIDE_FROM_64[0] == "constexpr int kWideDqAbove = 128;"
    for name, (_, edits) in tool.VARIANTS.items():
        if name.startswith("dq_"):
            assert tool.kernels_of(name) == ("dq",)
            assert all("Dq" in old for old, _ in edits), name
    assert tool.kernels_of("package") == tool.kernels_of("parent") == \
        ("dq", "dkv")
    assert tool.DQ_ENTRY in _cuda._SIGNATURES
    assert tool.ENTRIES[tool.SOURCE] in _cuda._SIGNATURES
