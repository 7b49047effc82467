"""The frozen counts against cases worked by hand."""
import math

import benchtiny
from counts import kernels as kc
from counts import model as cm
from families import decoder as dense
from counts.peaks import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, least_seconds


def test_causal_pairs():
    assert kc.row_pairs(1, 0) == 1
    assert kc.row_pairs(3, 0) == 6            # 1 + 2 + 3
    assert kc.row_pairs(2, 5) == 6 + 7        # queries at 5 and 6
    assert cm.pairs(4, 10) == 11 + 12 + 13 + 14


def test_attention_forward_by_hand():
    # one query row of 2 at offset 3, 4 heads of 8 over 2 kv heads, bf16
    nbytes, ops = kc.attention_fwd(2, 16, 4, 2, 8, 2, [3])
    assert nbytes == 2 * 2 * 4 * 8 * 2 + 2 * 5 * 2 * 8 * 2   # q, o; K/V 0..4
    assert ops == 4 * 8 * 4 * (4 + 5)
    # decode: two rows, one query each, at positions 0 and 9
    nbytes, ops = kc.attention_fwd(1, 16, 4, 2, 8, 2, [0, 9])
    assert ops == 4 * 8 * 4 * (1 + 10)
    assert nbytes == 2 * 2 * 1 * 4 * 8 * 2 + 2 * (1 + 10) * 2 * 8 * 2


def test_attention_backward_by_hand():
    nbytes, ops = kc.attention_bwd(1, 4, 2, 1, 8, 2)
    assert ops == 2.5 * 4 * 8 * 2 * 10
    assert nbytes == (4 * 4 * 2 * 8 + 4 * 4 * 1 * 8) * 2 + 2 * 4 * 4


def test_least_time_is_the_longer_bound():
    assert least_seconds(HBM_BYTES_PER_S, 0, PEAK_BF16_FLOPS) == 1.0
    assert least_seconds(0, PEAK_BF16_FLOPS, PEAK_BF16_FLOPS) == 1.0
    assert kc.least((0, 67e12), "float32") == 1.0


DENSE = {"reference": "decoder", "hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "num_hidden_layers": 3,
         "intermediate_size": 16, "vocab_size": 100}


def test_model_operations_by_hand():
    attn = 8 * (2 + 2) * 4 + 2 * 4 * 8           # q, k, v; o
    assert dense.body_params(DENSE) == 3 * (attn + 3 * 8 * 16)
    assert dense.head_params(DENSE) == 800
    assert dense.attn_pair_flops(DENSE) == 4 * 2 * 4 * 3
    body, head = dense.body_params(DENSE), dense.head_params(DENSE)
    # 2 rows of 4: 6 a parameter a token, 3x the 10 pairs of a row
    assert math.isclose(cm.train_flops(DENSE, 2, 4),
                        6 * 8 * (body + head) + 3 * 96 * 2 * 10)


def test_qwen_step_by_hand():
    """qwen1.5-0.5b at B 8 x S 4096: 24 layers of 4 x 1024^2 attention
    and 3 x 1024 x 2816 MLP weights, the 151936 x 1024 head."""
    cfg = {"reference": "decoder", "hidden_size": 1024,
           "num_attention_heads": 16, "num_key_value_heads": 16,
           "num_hidden_layers": 24, "intermediate_size": 2816,
           "vocab_size": 151936}
    body = 24 * (4 * 1024 ** 2 + 3 * 1024 * 2816)
    assert dense.body_params(cfg) == body == 308_281_344
    flops = cm.train_flops(cfg, 8, 4096)
    assert math.isclose(flops, 6 * 32768 * (body + 151936 * 1024)
                        + 3 * 4 * 1024 * 24 * 8 * 4096 * 4097 // 2)
    # the cell's own file, through its family, to the last bit
    assert cm.train_flops(benchtiny.config_file("qwen1.5-0.5b"), 8, 4096) \
        == 6 * 32768 * (body + 151936 * 1024) \
        + 3 * 4 * 1024 * 24 * 8 * 4096 * 4097 // 2
