"""The port's configs equal the reference's, field for field."""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import dataclasses

import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.configs import base as jbase
from repro_torch.configs import base as tbase

ARCHS = jbase.list_archs()


def test_same_registry():
    assert tbase.list_archs() == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_smoke_equal(arch):
    ref, port = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(tbase.smoke_config(port))
            == dataclasses.asdict(jbase.smoke_config(ref)))
    for a, b in ((ref, port), (jbase.smoke_config(ref),
                               tbase.smoke_config(port))):
        assert (a.hd, a.layer_kinds, a.n_groups, a.remainder,
                a.n_attn_layers) == (b.hd, b.layer_kinds, b.n_groups,
                                     b.remainder, b.n_attn_layers)
        assert b.tdtype == {"bfloat16": torch.bfloat16,
                            "float32": torch.float32}[a.dtype]
