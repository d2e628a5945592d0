"""The card's attention bodies of head widths above 256
(``csrc/attention_wide.cuh``) run on the CPU through
``hgr_tpu_torch.tools.emulate_wide``: g++ compiles their device code, one
fiber per CUDA thread runs it, and the forward and both backward kernels,
packed and split, are held against the plain versions at the card's
tolerances (the split outputs equal to the packed ones bit for bit).

The cases cover the bulk-copied rows with zero padding (264: a multiple
of 8 features, not of 64), element-by-element staging (257), a width of
whole 64-feature slices (320), and heads wider than one staged row (576,
640: the scores summed over feature groups, two output groups), each past
one chunk of keys where the length allows.
"""

import shutil

import pytest

from hgr_tpu_torch.tools import emulate_wide as E

CASES = [("bfloat16", 1, 40, 2, 264), ("float32", 1, 33, 1, 320),
         ("bfloat16", 1, 17, 1, 257), ("bfloat16", 1, 40, 1, 576),
         ("float32", 1, 17, 1, 640)]


@pytest.fixture(scope="module")
def emulator():
    if shutil.which("g++") is None:
        pytest.skip("the emulator needs g++")
    return E.build()


@pytest.mark.parametrize("dtype,b,n,heads,head_dim", CASES)
def test_emulated_wide_bodies_match_plain_versions(emulator, dtype, b, n,
                                                   heads, head_dim):
    row = E.run_case(dtype, b, n, heads, head_dim)
    assert row["finite"], row
    assert row["fwd_excess"] <= 0, row
    assert row["bwd_excess"] <= 0, row
    assert row["split_equals_packed"], row
