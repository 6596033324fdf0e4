"""The reduced jamba (attention, Mamba and MoE layers) and rwkv6 under a
(2, 2) mesh, on real values, against the plain port: the checks and the
rank script of ``tests/test_torch_mesh_model.py`` (loss, gradients, train
steps with compressed gradients, prefill, decode)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mesh_model import run_cases  # noqa: E402

FAMILIES = ("jamba-2x2", "rwkv6-2x2")


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return run_cases(FAMILIES, tmp_path_factory)


@pytest.mark.parametrize("case", FAMILIES)
def test_family_mesh_model_matches_plain(case, outcomes):
    assert outcomes[case] is None, outcomes[case]
