"""SAM and NewCRF engines serialized through ``torch.export`` and
deserialized, on the CPU: in each kernel mode the deserialized engine gives
the live engine's bits, and its program calls the mode's ``tpudepth::*``
ops once a block (the eager forward's launches), twice with flip-TTA.
One mode runs with flip-TTA, which GuideDepth and the zoo hold too (a
flip-TTA trace is twice as long); the meters conversion of a sigmoid map is
the constant max depth, so it is held on GuideDepth and the zoo
(``tests/test_torch_port_export.py``, with the ops themselves).
"""

import pytest

from torch_port_helpers import round_trip
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model

# (model, mode, the ops of one block, blocks a forward, flip-TTA)
CASES = [
    ("sam", "fused", ("window_attn_infer", "block_epilogue_infer"), 4, True),
    ("sam", "pair", ("window_attn_infer", "mlp_infer"), 4, False),
    ("sam", "row", ("sam_rowblock_infer",), 4, False),
    ("sam", "block", ("sam_block_infer",), 4, False),
    ("newcrf", "row", ("crf_rowblock_infer",), 8, False),
    ("newcrf", "fused", ("window_attn_infer", "block_epilogue_infer"), 8,
     False),
    ("newcrf", "pair", ("window_attn_infer", "mlp_infer"), 8, False),
    ("newcrf", "block", ("crf_block_infer",), 8, False),
]


@pytest.mark.parametrize("name,mode,ops,blocks,tta", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_attention_engine_round_trips_bit_for_bit(tmp_path, name, mode, ops,
                                                  blocks, tta):
    model = init_random_(build_model(name, attn=mode), seed=11)
    # 32x64: the stages' maps (1x2 to 8x16) are padded to whole windows
    got = round_trip(tmp_path, model, (32, 64), tta=tta, meters=False,
                     seed=12)
    assert got == {op: blocks * (1 + tta) for op in ops}

