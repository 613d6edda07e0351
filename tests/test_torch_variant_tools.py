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
