"""``hypad_tpu_torch.profile_kernels``' K2 parts on the CPU: the probe and
variant sources of K2's group kernels, and where ``chip_smoke.py`` holds K2
to the parent's bits or at tie level."""

from __future__ import annotations

import difflib
import re

import pytest

from hypad_tpu_torch import _build
from hypad_tpu_torch.profile_kernels import (
    K2_CONSTANTS,
    K2_PROBES,
    NARROW_SHAPE,
    k2_tie_level,
    k3_constants,
    k3_probe_source,
    k3_variant_source,
    kde_shapes,
)


def source():
    return (_build.CSRC / "kde_argmax.cu").read_text()


@pytest.mark.parametrize("name", sorted(K2_PROBES))
def test_k2_probes_change_only_their_text(name):
    """Each K2 probe rewrites every line it names and no other, and leaves
    none of its old text behind."""
    text = source()
    out = k3_probe_source(text, name, K2_PROBES)
    assert out != text
    for (old, new), _ in K2_PROBES[name]:
        assert out.count(old) == 0 or old in new
    changed = [line[2:] for line in difflib.ndiff(text.splitlines(),
                                                   out.splitlines())
               if line.startswith("- ")]
    assert changed and all(any(old.strip() in line
                               for (old, _), _ in K2_PROBES[name])
                           for line in changed)


def test_k2_probe_of_a_source_without_its_text_fails():
    """A source that holds none of a probe's text is refused, so a probe
    never times the unchanged kernel under its name."""
    text = source().replace("    sync();\n", "    sync();  \n")
    with pytest.raises(RuntimeError):
        k3_probe_source(text, "no_bar", K2_PROBES)


@pytest.mark.parametrize("name", K2_CONSTANTS)
def test_every_k2_constant_is_a_variant(name):
    """Each name ``--k2-variant`` takes is one ``constexpr int`` of
    csrc/kde_argmax.cu, rewritten alone; K3's names are refused there."""
    text = source()
    value = int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    out = k3_variant_source(text, f"{name}={value + 1}", K2_CONSTANTS)
    changed = [b for a, b in zip(text.splitlines(), out.splitlines())
               if a != b]
    assert changed == [f"constexpr int {name} = {value + 1};"]
    with pytest.raises(ValueError):
        k3_variant_source(text, "kK3GroupThreads=256", K2_CONSTANTS)


@pytest.mark.parametrize("width,tie", [(1, True), (128, True),
                                       (129, True), (256, True), (257, True),
                                       (4096, True), (4097, False)])
def test_chip_smoke_holds_k2_at_tie_level_on_group_rows(width, tie):
    """``chip_smoke.k2_tie_level``: K2's bits may differ from the parent's
    wherever its term is the SFU's ex2 (every row up to kK3TriMaxW, the
    narrow kernel's too) and, with expf, on its group kernels' rows above
    256; nowhere else."""
    import chip_smoke

    c = k3_constants(names=("kK3TriMaxW", "kK2Ex2"))
    assert c["kK3TriMaxW"] == 4096
    want = tie and (c["kK2Ex2"] == 1 or width > 256)
    assert chip_smoke.k2_tie_level(width) is want


def test_narrow_only_is_the_detect_shape_alone():
    """``--narrow-only`` times and checks the univariate detect's rows
    (20,099 of 100) alone, the first of the --wide-only shapes."""
    (label, n, w), = kde_shapes(narrow_only=True)
    assert (n, w) == NARROW_SHAPE and label == "narrow (20099, 100)"
    assert kde_shapes()[0] == (label, n, w) and len(kde_shapes()) > 1


@pytest.mark.parametrize("ex2,width,tie", [
    (1, 1, True), (1, 100, True), (1, 4096, True), (1, 4097, False),
    (0, 100, False), (0, 256, False), (0, 257, True), (0, 4097, False)])
def test_k2_tie_level_follows_the_term(ex2, width, tie):
    """K2 may leave a parent's bits wherever its term is the SFU's ex2
    (every width its narrow kernel and group kernels take), or with expf
    on the group kernels' rows above 256 columns."""
    text = k3_variant_source(source(), f"kK2Ex2={ex2}", K2_CONSTANTS)
    assert k2_tie_level(width, text) is tie
