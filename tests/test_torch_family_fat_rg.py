"""The FAT step of recurrentgemma-9b (5 of its 8 reduced layers: one
``R,R,L`` period and the ``R,R`` tail) and seamless-m4t-medium (one
encoder and one decoder layer) against the reference's jitted step, held
as tests/test_torch_family_fat.py holds the other families (its module
docstring states the bounds).  A file of their own: the reference's FAT
steps of these two compile for about a minute on one CPU, and
``--dist loadfile`` gives each file to one worker."""
import pytest
import torch

from test_torch_family_fat import check_family

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ("recurrentgemma-9b",
                                  "seamless-m4t-medium"))
def test_fat_step_equals_reference(arch, monkeypatch):
    check_family(arch, monkeypatch)
