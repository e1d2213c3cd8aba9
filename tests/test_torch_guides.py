"""The port's guides (``raydp_tpu_torch/doc/long_context.md``,
``migration.md`` and ``tutorial_data_processing.md``) against the code they
describe:

- every fenced code block of the tutorial is lifted from
  ``raydp_tpu_torch/examples/stroke_pipeline.py``: its lines are a run of
  the file's lines, less the indentation of the function they sit in;
- every repo path the three guides name exists (in inline code or as a
  link target), and a ``file::test_name`` names a test of that file;
- every time in them stands in a paragraph that names the card and its
  power limit (or right after one, for a table), and no line that holds a
  number speaks of a TPU.
"""

import os
import re
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(REPO, "raydp_tpu_torch", "doc")
GUIDES = ("long_context.md", "migration.md", "tutorial_data_processing.md")
STROKE = os.path.join(REPO, "raydp_tpu_torch", "examples",
                      "stroke_pipeline.py")
CARD = ("NVIDIA H100 80GB HBM3", "700.00 W")

_FENCE = re.compile(r"^```[a-z]*\n(.*?)^```", re.M | re.S)
_INLINE = re.compile(r"`([^`\n]+)`")
_LINK = re.compile(r"\]\(([^)\s]+)\)")
_PATH = re.compile(r"^(?:[\w.-]+/)+[\w.-]+\.(?:py|md|cu|cuh|cpp|ipynb|json"
                   r"|toml)(?:::\w+|:\d+(?:-\d+)?)?$")
_TIME = re.compile(r"\b\d+(?:\.\d+)?\s?(?:ms|s)\b")


def _read(name):
    with open(os.path.join(DOC, name)) as f:
        return f.read()


def _prose(text):
    """The guide without its fenced code blocks."""
    return _FENCE.sub("", text)


def test_tutorial_code_blocks_are_lifted_from_the_example():
    with open(STROKE) as f:
        lines = f.read().split("\n")
    blocks = _FENCE.findall(_read("tutorial_data_processing.md"))
    assert len(blocks) >= 10, len(blocks)
    for block in blocks:
        want = block.rstrip("\n").split("\n")
        n = len(want)
        found = any(
            textwrap.dedent("\n".join(lines[i:i + n])).split("\n") == want
            for i in range(len(lines) - n + 1))
        assert found, f"not in stroke_pipeline.py:\n{block}"


@pytest.mark.parametrize("guide", GUIDES)
def test_every_path_a_guide_names_exists(guide):
    text = _read(guide)
    prose = _prose(text)
    named = [m for m in _INLINE.findall(prose) if _PATH.match(m)]
    assert len(named) >= 3, named
    for ref in named:
        path, _, test = ref.partition("::")
        path = re.sub(r":\d+(?:-\d+)?$", "", path)
        full = os.path.join(REPO, path)
        assert os.path.isfile(full), f"{guide} names {ref}: no such file"
        if test:
            with open(full) as f:
                assert re.search(rf"^def {test}\(", f.read(), re.M), \
                    f"{guide} names {ref}: no such test"
    for target in _LINK.findall(prose):
        full = os.path.normpath(os.path.join(DOC, target))
        assert os.path.isfile(full), f"{guide} links {target}: no such file"


@pytest.mark.parametrize("guide", GUIDES)
def test_every_time_stands_beside_the_card(guide):
    paragraphs = _prose(_read(guide)).split("\n\n")
    for i, para in enumerate(paragraphs):
        for line in para.split("\n"):
            if re.search(r"\d", line):
                assert "TPU" not in line, f"{guide}: {line}"
        if not _TIME.search(para):
            continue
        # a table's times stand under the paragraph that introduces it
        context = paragraphs[i - 1] + para if para.lstrip().startswith("|") \
            else para
        assert all(c in context for c in CARD), \
            f"{guide}: a time without the card and its limit:\n{para}"
