"""bf16 parity of the port on the hybrid family (Zamba2: 6 Mamba blocks
and the shared attention + FFN block) in its own dtype: the reduced config
in bf16, ``test_torch_bf16.py::_pair``'s weights on both sides (the checks
are in ``helpers/bf16_ssm.py``; the rounding points of a Mamba block and
their repair in ``test_torch_bf16_ssm.py``; the two-phase search in
``test_torch_bf16_ssm_search.py``).

Bars (a bf16 ulp of a tensor's scale):
- one Mamba block on the same bf16 input, each block of the stack: the
  port parts from the reference's jitted ``ssm_forward`` on at most 1 % of
  the outputs;
- the forward (2 x 64 tokens), logits and every collected block output:
  Zamba2's forward grows one-ulp partings over its depth, as the
  reference's own forward does, so its elementwise bar is the reference's
  spread where that exceeds 2 ulps: the largest distance in ulps, of 2
  draws, between the reference's bf16 forward and the same forward with
  0.1 % of the embedding table's elements moved by one bf16 ulp.
  Measured (4 draws): logits 5.5-7.0 ulps, the shared block's output
  2.1-3.9; the port reads 2.5 and 1.0. No farther from the reference's
  fp32 than 1.25 x the reference's bf16 (unchanged);
- prefill + 3 decode steps (conv windows bf16, SSD state f32, the shared
  block's KV bf16): ``test_torch_bf16.py``'s dtype bar (2 ulps
  elementwise, 1.25 x fp32);
- RTN bit for bit; ``BatchedServer``'s greedy tokens equal to the
  reference's with ``use_flash_decode`` off and on (the shared block's
  decode through ``flash_decode``); ``init_cache`` follows the compute
  dtype.
"""
import dataclasses

import pytest
import torch

from helpers import bf16_ssm
from helpers.bf16_families import (ZAMBA, assert_batched_server_matches,
                                   assert_rtn_equals_reference, packed_bf16, pair)
from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro_torch.models import model as tmodel

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = pytest.mark.parametrize("arch", [ZAMBA], ids=["zamba2"])


@ARCH
def test_mamba_block_bf16_parts_from_the_reference_on_few_outputs(arch):
    bf16_ssm.assert_blocks_part_on_few_outputs(arch)


@ARCH
def test_ssm_forward_bf16_within_the_bar(arch):
    bf16_ssm.assert_forward_within_the_bar(arch, spread=True)


@ARCH
def test_rtn_bf16_equals_reference(arch):
    assert_rtn_equals_reference(arch)


@ARCH
def test_ssm_prefill_and_decode_bf16_within_the_dtype_bar(arch):
    bf16_ssm.assert_prefill_and_decode_within_the_dtype_bar(arch)


@ARCH
def test_batched_server_bf16_matches_reference(arch):
    """Greedy tokens equal to the reference's with ``use_flash_decode`` off
    and on."""
    assert_batched_server_matches(packed_bf16(arch), (False, True))


def test_ssm_cache_follows_the_compute_dtype():
    _, tcfg, _, _, _, _ = pair(ZAMBA)
    cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    assert cache["ssm"]["state"].dtype == torch.float32
    assert cache["ssm"]["conv"]["x"].dtype == torch.bfloat16
    assert cache["attn"]["k"].dtype == torch.bfloat16
    f32 = dataclasses.replace(tcfg, param_dtype="float32",
                              compute_dtype="float32")
    assert tmodel.init_cache(f32, 2, 16, device="cpu")["attn"]["k"].dtype \
        == torch.float32
