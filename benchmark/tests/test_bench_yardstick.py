"""The frozen counts of work equal hand arithmetic at small shapes, and
the repaired idle share counts the host's gaps at the window's edges."""
import pytest

from benchmark import trace, yardstick as Y


def test_attention_counts_by_hand():
    # rows of 2 and 3 real positions, 1 head of width 4, bf16
    nbytes, flops = Y.attention_fwd_work([2, 3], 1, 4)
    assert flops == 4 * (3 + 6) * 4  # QK^T and PV over 3 + 6 causal pairs
    assert nbytes == 4 * 5 * 4 * 2 + 2 * 5 * 4  # q, k, v, o; two fp32 statistics a row
    nbytes, flops = Y.attention_bwd_work([2, 3], 1, 4)
    assert flops == 8 * 9 * 4
    assert nbytes == 8 * 5 * 4 * 2 + 2 * 5 * 4


def test_decode_step_by_hand():
    plm = {"vq_dim": 2, "tc_latent_dim": 2, "n_layers": 1, "vq_bins": 3}
    nbytes, flops = Y.plm_decode_step_work(plm, B=1, T=3)
    d = 4
    weights = (3 * d * d + d * d + 4 * d * d + 4 * d * d) + 4 * 2 * (3 * d + d + 4 * d + d)
    head = 3 * d + 4 * 3
    kv = 1 * 2 * d * 2 * 2.0  # one layer, one row, k and v in bf16, mean length (3 + 1) / 2
    assert nbytes == weights + head + kv
    assert flops == 2 * 12 * d * d + 2 * d * 3 + 4 * d * 2.0


def test_train_flops_by_hand():
    plm = {"vq_dim": 2, "tc_latent_dim": 2, "n_layers": 1, "vq_bins": 3, "n_heads": 2}
    params = 12 * 16 + 4 * 3
    attn = 4 * 3 * 2 * 2 + 8 * 3 * 2 * 2  # rows [2]: 3 pairs, 2 heads of width 2
    assert Y.plm_train_flops(plm, [2]) == 6 * params * 2 + attn


def test_least_time_takes_the_longer_bound():
    assert Y.least_time(989e12, 0) == pytest.approx(1.0)
    assert Y.least_time(0, 3.35e12) == pytest.approx(1.0)
    assert Y.least_time(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_synthesis_flops_sum_their_stages():
    cfg = {"g": {"mrte": {"hidden_size": 4, "content_n_layers": 1, "content_ff_dim": 8,
                          "mel_bins": 2, "mel_n_layer": 1, "mel_n_stack": 1, "mel_n_block": 1,
                          "mel_kernel_size": 3, "mel_stride": 2},
                 "vqpe": {"vq_dim": 2}, "hidden_size": 4, "decoder_n_stack": 1,
                 "decoder_n_block": 1, "kernel_size": 3},
           "plm": {"vq_dim": 2, "tc_latent_dim": 2, "n_layers": 1, "vq_bins": 3},
           "adm": {"emb_dim": 2, "tc_emb_dim": 2, "tc_latent_dim": 4, "n_layers": 1},
           "vocoder": {"n_fft": 4, "dim": 2, "intermediate_dim": 3, "in_channels": 2,
                       "num_layers": 1}}
    out = Y.synthesis_flops(cfg, B=1, Tp=2, Tm=4, max_frames=8)
    assert out["total"] == sum(v for k, v in out.items() if k != "total")
    # the decoder alone: first conv 6→4, one block 4→4, last conv 4→2, k = 3, 8 frames
    assert out["decoder"] == 8 * 3 * (6 * 4 + 4 * 4 + 4 * 2) * 2


def test_idle_share_counts_gaps_at_the_window_edges():
    """Device ops cover [0.2, 0.4] and [0.5, 0.7] of a window [0, 1]: busy
    0.4 s; the host's 0.2 s before the first op and 0.3 s after the last
    count as idle (the first-to-last-op window of the tool read 0.5 s)."""
    ops = [("a", 0.2, 0.4), ("b", 0.5, 0.7), ("c", 0.65, 0.7), ("outside", 1.2, 1.3)]
    out = trace.summarize(ops, 0.0, 1.0, [("setup", 0.0, 0.2), ("loop", 0.2, 1.0)])
    assert out["busy_s"] == pytest.approx(0.4)
    assert out["window_s"] == 1.0
    idle = dict(out["idle_gaps"])
    assert idle["setup"] == pytest.approx(0.2) and idle["loop"] == pytest.approx(0.4)
    assert out["op_count"] == {"a": 1, "b": 1, "c": 1}
    assert trace.kernel_time(out, "a", "c") == (pytest.approx(0.25), 2)
