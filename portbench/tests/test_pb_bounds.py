"""The yardstick's operation and byte counts on hand-checked shapes."""

import torch

from portbench.common import bounds
from portbench.reference import llama_decoder as ref_dec


def test_iso_pairs_counts_the_sdag_mask():
    for length, sul, spans in [(10, 2, [(2, 5), (6, 9)]),
                               (30, 4, [(4, 10), (10, 18), (19, 27)]),
                               (7, 7, [])]:
        seq = ref_dec.Seq(list(range(length)), length, sul,
                                tuple(spans))
        want = int(ref_dec.mask_for(seq, "cpu").sum())
        assert bounds.iso_pairs(length, sul, spans) == want
    assert bounds.causal_pairs(4) == 10


def test_k1_bound_hand_checked():
    # two prompts (3 valid, 6 pairs), (2, 3): 9 pairs x 4 x Hq 2 x Dh 4
    f, b, s = bounds.k1_bound([(3, 6), (2, 3)], hq=2, hkv=1, dh=4,
                              dtype="bfloat16")
    assert f == 4.0 * 9 * 2 * 4
    assert b == (2 * 2 + 2 * 1) * 5 * 4 * 2 + 12 * 5
    assert s == max(f / 989e12, b / 3.35e12)


def test_decoder_flops_hand_checked():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 16,
           "num_hidden_layers": 1, "vocab_size": 10}
    layers, head = bounds.decoder_matmul_params(cfg)
    assert layers == 8 * 8 * 2 + 2 * 8 * 4 + 3 * 8 * 16 and head == 80
    # a 3-token prompt with 6 pairs, one answer of 2 tokens fed after it
    f = bounds.decoder_flops(cfg, [(3, 6)], [(3, 2)])
    want = (2 * layers * 3 + 2 * head + 4 * 6 * 2 * 4
            + (2 * layers + 2 * head) * 2 + 4 * (2 * 3 + 3) * 2 * 4)
    assert f == want


def test_trace_union_never_double_counts():
    from portbench.common.trace import _union
    busy, merged = _union([(0, 10), (5, 15), (20, 30), (29, 31)])
    assert busy == 26 and merged == [[0, 15], [20, 31]]
    assert torch.tensor(busy) > 0
