"""The card's bf16 key-chunked attention backward at padded head widths
128 and 256, the ring pair of ``csrc/attention_qkv_bwd.cu`` (a query
kernel: dq and the rows' statistics; a key kernel: dk and dv, each key
tile's dk and dv summed by two warps at these widths), run on the CPU
through ``hgr_tpu_torch.tools.emulate_wide`` (see
``test_torch_ring_emulated.py`` for how). Each case is held against the
plain version at the card's gradient tolerance, the split operands
against the packed ones bit for bit, and the ring pair against the
two-buffer pair (``tools/emulate/chunked_bwd.cuh``) bit for bit: both
take the whole-sequence body's 16-row steps in its order.

The lengths run past two of the ring's 32-row chunks and end in a masked
one; 113 at 2 x 128 makes four chunks, so the key kernel's three buffers
are reused, and two blocks of query tiles; 192 features leave zero
columns of Dp = 256.
"""

import shutil

import pytest

from hgr_tpu_torch.tools import emulate_wide as E

CASES = [(1, 113, 2, 128), (1, 81, 1, 192), (1, 81, 1, 256)]


@pytest.fixture(scope="module")
def emulator():
    if shutil.which("g++") is None:
        pytest.skip("the emulator needs g++")
    return E.build()


@pytest.mark.parametrize("b,n,heads,head_dim", CASES)
def test_emulated_ring_backward_matches_plain_version(emulator, b, n, heads,
                                                      head_dim):
    row = E.run_ring_case(b, n, heads, head_dim, kernel="bwd")
    assert row["finite"], row
    assert row["bwd_excess"] <= 0, row
    assert row["split_equals_packed"], row
    assert row["ring_equals_chunked"], row
