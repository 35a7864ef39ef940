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
    k3_constants,
    k3_probe_source,
    k3_variant_source,
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


@pytest.mark.parametrize("width,tie", [(1, False), (128, False),
                                       (129, True), (256, True), (257, True),
                                       (4096, True), (4097, False)])
def test_chip_smoke_holds_k2_at_tie_level_on_group_rows(width, tie):
    """``chip_smoke.k2_tie_level``: K2's bits may differ from the parent's
    on its group kernels' rows (129 to kK3TriMaxW with the ex2 term; above
    256 only with expf), nowhere else."""
    import chip_smoke

    c = k3_constants(names=("kK3TriMaxW", "kK2Ex2"))
    assert c["kK3TriMaxW"] == 4096
    want = tie and (c["kK2Ex2"] == 1 or width > 256)
    assert chip_smoke.k2_tie_level(width) is want
