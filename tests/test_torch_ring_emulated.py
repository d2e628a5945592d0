"""The card's bf16 key-chunked attention forward, the ring body of
``csrc/attention_qkv_fwd.cu``, at every padded head width, run on the CPU
through ``hgr_tpu_torch.tools.emulate_wide``: g++ compiles the kernels
with ``csrc/attention_mma.cuh``'s helpers as written (its PTX primitives
stood in for), one fiber per CUDA thread runs them, and the ring's
mbarrier waits yield until their phase completes. Each case is held
against the plain version at the card's tolerance, the split operands
against the packed ones bit for bit, and the ring against the two-buffer
key-chunked kernel (``tools/emulate/chunked_fwd.cuh``) bit for bit (both
take the same steps in the same order). This checks indexing, masking
and the ring's staging and buffer turns without a card; not bits of the
tensor cores, not speed.

The lengths run past two chunks of keys (160 at Dp = 16, 96 at Dp = 64,
48 at 128, 32 at 256), so every ring buffer is reused and the last chunk
is partly masked; 113 at 2 x 128 also takes a second block of query
tiles. 12 features and 100 take the element-by-element staging, 40 the
zero columns of Dp = 64, 192 those of Dp = 256.
"""

import shutil

import pytest

from hgr_tpu_torch.tools import emulate_wide as E

CASES = [(1, 337, 2, 16), (1, 193, 2, 64), (1, 161, 1, 40),
         (1, 177, 1, 12), (1, 113, 2, 128), (1, 100, 1, 192),
         (1, 81, 1, 256), (1, 113, 1, 100)]


@pytest.fixture(scope="module")
def emulator():
    if shutil.which("g++") is None:
        pytest.skip("the emulator needs g++")
    return E.build()


@pytest.mark.parametrize("b,n,heads,head_dim", CASES)
def test_emulated_ring_forward_matches_plain_version(emulator, b, n, heads,
                                                     head_dim):
    row = E.run_ring_case(b, n, heads, head_dim)
    assert row["finite"], row
    assert row["fwd_excess"] <= 0, row
    assert row["split_equals_packed"], row
    assert row["ring_equals_chunked"], row
