"""bf16 parity of the port's two servers on Qwen3-4B reduced in its own
dtype (the reference's bf16 weights packed at 2-bit g32 on both sides):
greedy tokens and batcher stats identical to the reference's, with
sharing off and on, and the paged server's tokens to a bf16 greedy oracle
(a full forward per token); ``BatchedServer``'s tokens with
``use_flash_decode`` off and on identical to the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.core import quant as jq
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import Request as JRequest
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from test_torch_bf16 import _pair
from test_torch_dense_archs import _greedy_oracle, _run_both_batchers

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_packed_bf16():
    jcfg, tcfg, jp, _, _, _ = _pair("qwen3-4b")
    jpq = jpack_model(jp, jq.QuantConfig(bits=2, group_size=32))
    return jcfg, tcfg, jpq, params_from_numpy(jax.tree.map(np.asarray, jpq),
                                              "cpu")


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["off", "on"])
def test_paged_server_bf16_matches_reference(qwen_packed_bf16, prefix_cache):
    rng = np.random.default_rng(7)
    psz = 4
    sys_p = rng.integers(0, 512, size=2 * psz).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, size=n).astype(
        np.int32)]) for n in (3, 7, 1)]
    outs, _ = _run_both_batchers(
        qwen_packed_bf16, prompts, 4, n_pages=40, page_size=psz, max_pages=8,
        max_batch=3, prefill_chunk_pages=1, prefix_cache=prefix_cache)
    _, tcfg, _, tpq = qwen_packed_bf16
    for p, out in zip(prompts[:2], outs):
        assert out == _greedy_oracle(tpq, tcfg, p, 4)


def test_batched_server_bf16_matches_reference(qwen_packed_bf16):
    jcfg, tcfg, jpq, tpq = qwen_packed_bf16
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new=int(m)) for n, m in [(5, 4), (11, 6), (3, 5)]]
    want = JBatchedServer(jpq, jcfg, batch_size=2, max_len=64).generate(
        [JRequest(**r) for r in reqs])
    for flash in (False, True):
        server = tserve.BatchedServer(
            tpq, dataclasses.replace(tcfg, use_flash_decode=flash),
            batch_size=2, max_len=64, device="cpu")
        assert server.generate([tserve.Request(**r) for r in reqs]) == want
