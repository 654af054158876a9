"""bf16 parity of the port's search on the hybrid family (Zamba2 reduced
in its own bf16, ``test_torch_bf16.py::_pair``'s weights on both sides;
``helpers/bf16_families.py`` holds the check and its bars): the
two-phase search (``search/api.py::_run_hybrid``): the Mamba phase
  (``MambaAdapter``, within-head moves, the unfused lane only: its fused
  flag warns and falls back, in both packages), then the shared FFN phase
  (``SharedFFNAdapter``), teacher-forced to the reference's decisions,
  both install modes, the port's unfused and fused lanes. The reference's
  shared adapter has no fused build and falls back too, so its unfused run
  is the comparand of both of the port's lanes; the port's fused shared
  phase runs ``transform_quant``. Zamba2's forward and ``BatchedServer`` are held
in ``test_torch_bf16_hybrid.py``.
"""
import pytest

from helpers.bf16_families import ZAMBA, assert_search_teacher_forced, search_refs
from helpers.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ref():
    return search_refs([(ZAMBA, False)])[ZAMBA, False]


@pytest.mark.parametrize("install", ["unit", "stack"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_hybrid_search_bf16_teacher_forced_to_reference(ref, fused, install,
                                                        monkeypatch):
    assert_search_teacher_forced(ref, ZAMBA, fused, install, monkeypatch)
