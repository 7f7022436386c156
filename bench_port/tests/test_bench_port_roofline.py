"""The yardstick's arithmetic against hand counts."""

import pytest

import roofline

YI = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=4,
          intermediate_size=11008, vocab_size=64000)
CNN = dict(height=28, width=28, channels=1, ksize=5, conv1=32, conv2=64,
           hidden=120, n_classes=62)


def test_k5_bounds_at_yi_shape():
    fwd = roofline.flash_bound(128, 2048, 2048, 128, True, None, 4, 8)
    bwd = roofline.flash_bwd_bound(128, 2048, 2048, 128, True, None, 4, 8)
    assert fwd["bound_ms"] == pytest.approx(0.833, abs=5e-4)
    assert bwd["bound_ms"] == pytest.approx(2.083, abs=5e-4)
    assert fwd["bound_by"] == bwd["bound_by"] == \
        "tensor-core operations (3xTF32)"


@pytest.mark.parametrize("sq,window", [(1, None), (7, None), (64, None),
                                       (64, 16), (33, 1)])
def test_live_pairs_counts_the_causal_band(sq, window):
    want = sum(1 for i in range(sq) for j in range(sq)
               if j <= i and (window is None or j > i - window))
    assert roofline.live_pairs(sq, sq, True, window) == want
    assert roofline.live_pairs(sq, sq + 3, False) == sq * (sq + 3)


@pytest.mark.parametrize("batch,seq,tflop", [(4, 2048, 48.55),
                                             (2, 4096, 50.20)])
def test_yi_step_flops(batch, seq, tflop):
    assert roofline.lm_matmul_params(YI, 4) == 954_204_160
    assert roofline.lm_step_flops(YI, 4, batch, seq) / 1e12 == \
        pytest.approx(tflop, abs=0.01)
