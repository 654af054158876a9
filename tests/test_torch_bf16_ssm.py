"""bf16 parity of the port on the SSM family (Mamba2) in its own dtype:
the reduced config with ``param_dtype = compute_dtype = "bfloat16"``,
``test_torch_bf16.py::_pair``'s weights on both sides (the checks are in
``helpers/bf16_ssm.py``; the hybrid's in ``test_torch_bf16_hybrid.py``).

The reference rounds as XLA compiles it on the CPU (``test_torch_bf16.py``).
Inside a Mamba block (``models/ssm.py``) its compiled forward rounds every
conv tap product, every partial sum and the bias add, and each of
``silu``'s four steps; it keeps the gate ``y * silu(z)`` unrounded into
the gated RMSNorm's f32 upcast; and in the decode step's conv it feeds the
tap products unrounded into the f32 sum, then rounds the sum and the bias
add. The port rounded ``silu`` once, the gate product and the decode
step's tap products to bf16: a block parted from the reference on 69-72 %
of its outputs, the whole forward by 2.38 ulps (Mamba2 logits) and 13.75
(Zamba2), the decode logits by 2.5 and 4.5. What remains after the repair
is the f32 ``exp`` (and ``cumsum`` order) of XLA and PyTorch parting by an
ulp in the SSD scan: a block parts on 0-0.3 % of its outputs (the dense
family's ~0.2 %).

Bars (a bf16 ulp of a tensor's scale, ``2 ** (floor(log2 max|ref|) -
7)``):
- one Mamba block on the same bf16 input, each block of the stack: the
  port parts from the reference's jitted ``ssm_forward`` on at most 1 % of
  the outputs;
- the forward (2 x 64 tokens), logits and every collected block output,
  and prefill + 3 decode steps (conv windows bf16, SSD state f32):
  ``test_torch_bf16.py``'s dtype bar, 2 ulps elementwise and no farther
  from the reference's fp32 than 1.25 x the reference's bf16;
- RTN bit for bit (``A_log``, ``D``, ``dt_bias`` f32 as in the
  reference; ``helpers/bf16_families.py``); ``BatchedServer``'s greedy
  tokens equal to the reference's.
"""
import pytest

from helpers import bf16_ssm
from helpers.bf16_families import (MAMBA, assert_batched_server_matches,
                                   assert_rtn_equals_reference, packed_bf16)
from helpers.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = pytest.mark.parametrize("arch", [MAMBA], ids=["mamba2"])


@ARCH
def test_mamba_block_bf16_parts_from_the_reference_on_few_outputs(arch):
    bf16_ssm.assert_blocks_part_on_few_outputs(arch)


@ARCH
def test_ssm_forward_bf16_within_the_bar(arch):
    bf16_ssm.assert_forward_within_the_bar(arch, spread=False)


@ARCH
def test_rtn_bf16_equals_reference(arch):
    assert_rtn_equals_reference(arch)


@ARCH
def test_ssm_prefill_and_decode_bf16_within_the_dtype_bar(arch):
    bf16_ssm.assert_prefill_and_decode_within_the_dtype_bar(arch)


@ARCH
def test_batched_server_bf16_matches_reference(arch):
    assert_batched_server_matches(packed_bf16(arch), (False,))
