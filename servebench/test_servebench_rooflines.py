"""The frozen FLOP and byte counts on worked cases."""
import pytest

from servebench import rooflines as R


def test_wna16_work():
    f, b = R.wna16_work(8, 4096, 11008, 4, 128)
    assert f == 2 * 8 * 4096 * 11008
    assert b == 8 * 4096 * 2 + 4096 * 11008 // 2 + 2 * 32 * 11008 * 4 \
        + 8 * 11008 * 2
    # at M = 8 the packed weight's bytes bound it; at M = 4096, the FLOPs
    assert R.least_s(f, b) == pytest.approx(b / 3.35e12)
    f2, b2 = R.wna16_work(4096, 4096, 11008, 4, 128)
    assert R.least_s(f2, b2) == pytest.approx(f2 / 989e12)


def test_paged_decode_work():
    # two live rows at positions 15 and 31 (16 and 32 tokens with their
    # own), 48 / 8 heads of 128, bf16 pool
    f, b = R.paged_decode_work([15, 31], 48, 8, 128, 16)
    assert f == 4 * 48 * 128 * (16 + 32)
    per_tok = 2 * 8 * 128 * 2
    assert b == (2 * (2 * 48 * 128 * 2 + 2 * 8 * 128 * 2 + 4)
                 + (15 + 31) * per_tok + (1 + 2) * 4)
    assert R.paged_decode_work([], 48, 8, 128, 16) == (0.0, 0.0)


def test_chunk_work():
    assert R.causal_pairs(0, 4) == 10
    assert R.causal_pairs(100, 4) == 410
    f, b = R.paged_chunk_work(100, 4, 48, 8, 128, 16)
    assert f == 4 * 48 * 128 * 410
    assert b == (2 * 4 * 48 * 128 * 2 + 4 * 2 * 8 * 128 * 2
                 + 100 * 2 * 8 * 128 * 2 + 7 * 4)
    f, b = R.paged_chunk_mla_work(0, 16, 128, 576, 512, 16)
    assert f == 2 * 128 * (576 + 512) * 136
    assert b == 16 * 128 * (576 + 512) * 4 + 16 * 576 * 2 + 1 * 4


def test_step_model_flops():
    m = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab": 100, "gated_mlp": False}
    attn = 2 * 64 * 4 * 16 + 2 * 64 * 2 * 16
    ffn = 2 * 64 * 128
    # a decode token at position 9 (10 pairs) and a 3-token prompt (6 pairs)
    f = R.step_model_flops(m, ["dense", "dense"], [], [(9, 1), (0, 3)], 2)
    assert f == 2 * (2 * (attn + ffn) * 4 + 4 * 4 * 16 * 16) + 2 * 64 * 100 * 2
    moe = dict(m, gated_mlp=True,
               moe={"n_routed_experts": 8, "top_k": 2, "n_shared_experts": 1,
                    "d_ff_expert": 32})
    p, _ = R.layer_matmul_params(moe, "moe")
    assert p == attn + 64 * 8 + 3 * 3 * 64 * 32
