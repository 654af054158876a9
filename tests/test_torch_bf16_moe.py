"""bf16 parity of the port on the MoE family (Phi-3.5-MoE reduced in its
own bf16, ``test_torch_bf16.py::_pair``'s weights on both sides;
``helpers/bf16_families.py`` holds the shared checks and their bars).
``test_torch_bf16.py`` says where the reference rounds and how the port
copies it, and holds Phi-3.5-MoE's forward; the servers are in
``test_torch_bf16_moe_encdec_serve.py``, the encoder-decoder and vision
families in ``test_torch_bf16_frontends.py``.

Bars:
- RTN bit for bit, leaf for leaf and dtype for dtype;
- the search (``MoEAdapter`` over L·E expert units) teacher-forced to the
  reference's (shared bars) on both lanes and both install modes.
"""
import pytest

from helpers.bf16_families import (MOE, assert_rtn_equals_reference,
                                   assert_search_teacher_forced, search_refs)
from helpers.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", [MOE], ids=["phi3.5"])
def test_rtn_bf16_equals_reference(arch):
    assert_rtn_equals_reference(arch)


CASES = [(MOE, False), (MOE, True)]


@pytest.fixture(scope="module")
def refs():
    return search_refs(CASES)


@pytest.mark.parametrize("install", ["unit", "stack"])
@pytest.mark.parametrize("arch,fused", CASES, ids=["phi3.5-unfused",
                                                   "phi3.5-fused"])
def test_search_bf16_teacher_forced_to_reference(refs, arch, fused, install,
                                                 monkeypatch):
    assert_search_teacher_forced(refs[arch, fused], arch, fused, install,
                                 monkeypatch)
