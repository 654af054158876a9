"""bf16 parity of the port's servers on the MoE and vision families (the
reduced configs in their own bf16, the reference's packed bf16 model at
2-bit g32 on both sides; ``helpers/bf16_families.py``). Bar: greedy tokens
and the paged batcher's stats equal to the reference's under the same
options: Phi-3.5-MoE and InternVL2 (on text), ``PagedServer``'s batcher
with sharing off and on (MoE capacity depends on a chunk's S, so each run
is held to the reference's run with its own options), and
``BatchedServer`` with ``use_flash_decode`` off and on. SeamlessM4T's
serving steps are in ``test_torch_bf16_frontends.py``.
"""
import numpy as np
import pytest

from helpers.bf16_families import INTERNVL, MOE, assert_batched_server_matches, packed_bf16
from helpers.torch_parity import one_torch_thread  # noqa: F401
from test_torch_dense_archs import _run_both_batchers

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", [MOE, INTERNVL], ids=["phi3.5", "internvl2"])
def test_servers_bf16_match_reference(arch):
    model = packed_bf16(arch)
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 512, size=8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, size=n).astype(
        np.int32)]) for n in (3, 7, 1)]
    for prefix_cache in (False, True):
        _run_both_batchers(model, prompts, 4, n_pages=40, page_size=4,
                           max_pages=8, max_batch=3, prefill_chunk_pages=1,
                           prefix_cache=prefix_cache)
    assert_batched_server_matches(model)
