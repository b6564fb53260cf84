"""The PLM decode replayed as a CUDA graph (``fast_decode.plm_fast_decode``
on the card) held against the same step run eagerly, on the card, at the
benchmark's synthesis geometry: B = 8 rows, T = 64 codes, the published
PLM widths with seeded random weights (``megatts.init_random_``), int8
weight-only, bf16.  Marked ``gpu``: without a CUDA device every test here
skips.  On a machine with a card and no JAX, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_graph.py

The replay and the eager step launch the same kernels on the same shapes, so
their codes are equal, greedy, sampled (two generators seeded alike),
with injected Gumbel noise and after a prompt's prefill.  Against the sliced
eager loop (``plm_decode_step``, which attends only the positions written)
the replay's logits, teacher-forced, agree within 2e-2 of the largest: bf16
products summed over another number of positions, through 12 layers.  The
counters: a shape seen before replays without a capture, a new (B, L)
captures once, and a weight reassigned captures again.

The ADM decode replayed as a CUDA graph (``fast_decode.adm_decode_raw`` on
the card) at the same geometry: B = 8 rows of T = 64 phones, the widths of
``configs/config_adm.yaml`` (``tc_emb_dim`` 512: d_model 768, head dim 96),
seeded random weights, bf16.  Its raw predictions equal those of the same
step run eagerly.  Against the sliced eager loop, which attends only the
positions written and feeds back its own predictions, they agree within
6e-2 of the largest: bf16 products summed over another number of positions,
through 8 layers and 64 steps of feedback (1.0-4.0% over 12 inputs on an
H100; bf16 against fp32 on the CPU reads 2%).  Rounded durations may then
differ by one frame, only where a raw value lies within that tolerance of a
.5 boundary, and in under 5% of the phones (0-4 of 512 on those inputs).  The tensor a decode returns is its own, untouched by the next
decode."""
import pytest
import torch

from megatts2_tpu_torch.config import MegaADMConfig, MegaPLMConfig
from megatts2_tpu_torch.models import MegaADM, MegaPLM
from megatts2_tpu_torch.models import fast_decode as fd
from megatts2_tpu_torch.models.megatts import init_random_
from megatts2_tpu_torch.quantization.weight_only import cast_float_, quantize_
from megatts2_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu

B, T, P = 8, 64, 32


@pytest.fixture(scope="module")
def plm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_(MegaPLM(MegaPLMConfig()), torch.Generator().manual_seed(0))
    model = quantize_(model.to("cuda").eval(), 8)
    return cast_float_(model, torch.bfloat16)


def _tc(model, seed, n=T):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, n, model.cfg.tc_latent_dim, generator=g).to("cuda")


def _eager(model, tc, temperature=0.0, top_k=0, generator=None, gumbel=None,
           init_cache=None, start_pos=0, prev0=None):
    """The captured step's function run eagerly over the same buffers."""
    g = fd.PLMStepGraph(model, tc.shape[0], start_pos + tc.shape[1], tc.device)
    with torch.inference_mode():
        out = g.decode(model, tc.to(model.plm.dtype), temperature, top_k, generator, gumbel,
                       init_cache, start_pos, prev0)
    assert g.graph is None
    return out


def _varied(codes):
    assert len(torch.unique(codes)) > 8, codes  # the weights give more than a few codes


def test_graph_greedy_equals_eager(plm):
    tc = _tc(plm, 1)
    got = fd.plm_fast_decode(plm, tc)
    assert torch.equal(got, _eager(plm, tc))
    _varied(got)


def test_graph_sampled_equals_eager(plm):
    tc = _tc(plm, 2)
    gens = [torch.Generator(device="cuda").manual_seed(7) for _ in range(2)]
    got = fd.plm_fast_decode(plm, tc, temperature=0.8, top_k=8, generator=gens[0])
    assert torch.equal(got, _eager(plm, tc, 0.8, 8, gens[1]))
    assert not torch.equal(got, fd.plm_fast_decode(plm, tc))
    _varied(got)


def test_graph_injected_noise_equals_eager(plm):
    tc = _tc(plm, 3)
    noise = fd.gumbel_noise((T, B, plm.cfg.vq_bins),
                            torch.Generator(device="cuda").manual_seed(9), "cuda")
    got = fd.plm_fast_decode(plm, tc, temperature=0.8, top_k=8, gumbel=noise)
    assert torch.equal(got, _eager(plm, tc, 0.8, 8, gumbel=noise))
    _varied(got)


def test_graph_prompted_equals_eager(plm):
    tc, ptc = _tc(plm, 4), _tc(plm, 5, P)
    g = torch.Generator().manual_seed(6)
    pcodes = torch.randint(0, plm.cfg.vq_bins, (B, P), generator=g).to("cuda")
    prev = torch.cat([torch.full_like(pcodes[:, :1], plm.cfg.bos_id), pcodes[:, :-1]], dim=1)
    with torch.inference_mode():
        caches = plm.plm.new_cache(B, P + T, tc.to(plm.plm.dtype))
        plm.prefill(ptc, prev, caches)
    got = fd.plm_fast_decode(plm, tc, init_cache=caches, start_pos=P, prev0=pcodes[:, -1])
    assert torch.equal(got, _eager(plm, tc, init_cache=caches, start_pos=P, prev0=pcodes[:, -1]))
    assert not torch.equal(got, fd.plm_fast_decode(plm, tc))
    _varied(got)


def test_graph_teacher_forced_logits_match_sliced_loop(plm):
    """Each step's logits of the replay, fed the greedy codes, against the
    sliced eager loop's."""
    tc = _tc(plm, 8)
    codes = fd.plm_fast_decode(plm, tc)
    tcb = tc.to(plm.plm.dtype)
    with torch.inference_mode():
        g = fd.step_graph(plm, B, T, tcb.device)
        g.cache.zero_()
        g.pos.fill_(0)
        caches = plm.plm.new_cache(B, T, tcb)
        prev = torch.full((B,), plm.cfg.bos_id, dtype=torch.long, device="cuda")
        have, want = [], []
        for t in range(T):
            g.tc_t.copy_(tcb[:, t])
            g.prev.copy_(prev)
            g.graph.replay()
            have.append(g.logits.clone())
            want.append(fd.plm_decode_step(plm, tcb[:, t], prev, caches, t))
            prev = codes[:, t]
    have, want = torch.stack(have, 1), torch.stack(want, 1)
    err = (have - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), (err, want.abs().max().item())


def test_graph_counters_and_capture_span(plm):
    tc = _tc(plm, 10)
    fd.plm_fast_decode(plm, tc)  # this shape captured before, or now
    c0, r0 = fd.plm_fast_decode.graph_captures, fd.plm_fast_decode.graph_replays
    fd.plm_fast_decode(plm, tc)
    assert (fd.plm_fast_decode.graph_captures, fd.plm_fast_decode.graph_replays) == (c0, r0 + T)

    tracing.enable()
    try:
        tracing.drain()
        short = fd.plm_fast_decode(plm, tc[:, :40])  # a new (B, L)
        spans = [s for s in tracing.drain() if s[0] == "plm.capture"]
    finally:
        tracing.disable()
    assert fd.plm_fast_decode.graph_captures == c0 + 1
    assert fd.plm_fast_decode.graph_replays == r0 + T + 40
    assert len(spans) == 1 and spans[0][3] == 40
    assert torch.equal(short, _eager(plm, tc[:, :40]))

    # in place: the graph reads the weights where they are, no capture
    head = plm.predict_layer
    head.scale.mul_(-1.0)
    flipped = fd.plm_fast_decode(plm, tc)
    assert fd.plm_fast_decode.graph_captures == c0 + 1
    assert torch.equal(flipped, _eager(plm, tc))
    head.scale.mul_(-1.0)

    # reassigned: a new address, captured again, reading the new storage
    w = head.weight_q
    w.data = w.data.flip(0).contiguous()
    got = fd.plm_fast_decode(plm, tc)
    assert fd.plm_fast_decode.graph_captures == c0 + 2
    assert torch.equal(got, _eager(plm, tc))
    w.data = w.data.flip(0).contiguous()


@pytest.fixture(scope="module")
def adm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_(MegaADM(MegaADMConfig(tc_emb_dim=512)), torch.Generator().manual_seed(0))
    return model.to("cuda", torch.bfloat16).eval()


def _tc_adm(model, seed, b=B, n=T):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, n, model.cfg.tc_latent_dim, generator=g).to("cuda")


def _adm_eager(model, tc):
    """The ADM's captured step run eagerly over the same buffers."""
    g = fd.ADMStepGraph(model, tc.shape[0], tc.shape[1], tc.device)
    with torch.inference_mode():
        out = g.decode(model, tc.to(model.adm.dtype))
    assert g.graph is None
    return out


def _adm_sliced(model, tc):
    """The sliced eager loop: ``adm_decode_raw``'s CPU path, on the card."""
    dtype = model.adm.dtype
    tc = tc.to(dtype)
    B_, T_ = tc.shape[:2]
    with torch.inference_mode():
        caches = model.adm.new_cache(B_, T_, tc)
        prev = torch.zeros(B_, dtype=torch.float32, device=tc.device)
        out = []
        for t in range(T_):
            dt_emb = fd.dense(model.dt_linear_emb, prev[:, None].to(dtype))
            x = torch.cat([fd.dense(model.tc_linear_emb, tc[:, t]), dt_emb], dim=-1)
            x = model.adm.step(x + model.pe[t].to(dtype), caches, t)
            prev = fd.dense(model.predict_layer, x)[:, 0].float()
            out.append(prev)
    return torch.stack(out, dim=1)


def _durations(model, raw):
    return torch.clamp((raw + 0.5).to(torch.int32), 1, model.cfg.max_duration_token).long()


def test_adm_graph_equals_eager_step(adm):
    tc = _tc_adm(adm, 11)
    got = fd.adm_decode_raw(adm, tc)
    assert torch.equal(got, _adm_eager(adm, tc))
    assert len(torch.unique(_durations(adm, got))) > 3, got


def test_adm_graph_matches_sliced_loop(adm):
    """Raw predictions against the sliced eager loop within 6e-2 of the
    largest; durations equal but within that tolerance of a .5 boundary."""
    tc = _tc_adm(adm, 12)
    have, want = fd.adm_decode_raw(adm, tc), _adm_sliced(adm, tc)
    tol = 6e-2 * want.abs().max().item()
    err = (have - want).abs().max().item()
    assert err <= tol, (err, want.abs().max().item())
    dh, dw = _durations(adm, have), _durations(adm, want)
    assert (dh - dw).abs().max().item() <= 1
    off = dh != dw
    boundary = torch.minimum(dh, dw)[off].float() + 0.5
    assert ((want[off] - boundary).abs() <= tol).all(), (want[off], boundary)
    assert off.float().mean().item() < 0.05, off.float().mean().item()
    assert torch.equal(fd.adm_fast_decode(adm, tc), dh)


def test_adm_graph_output_is_not_the_static_buffer(adm):
    a, b = _tc_adm(adm, 13), _tc_adm(adm, 14)
    first = fd.adm_decode_raw(adm, a)
    kept = first.clone()
    second = fd.adm_decode_raw(adm, b)
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


def test_adm_graph_counters_and_capture_span(adm):
    tc = _tc_adm(adm, 15)
    fd.adm_decode_raw(adm, tc)  # this shape captured before, or now
    c0, r0 = fd.adm_decode_raw.graph_captures, fd.adm_decode_raw.graph_replays
    p0 = (fd.plm_fast_decode.graph_captures, fd.plm_fast_decode.graph_replays)
    fd.adm_decode_raw(adm, tc)
    assert (fd.adm_decode_raw.graph_captures, fd.adm_decode_raw.graph_replays) == (c0, r0 + T)

    tracing.enable()
    try:
        tracing.drain()
        short = fd.adm_decode_raw(adm, tc[:5, :40])  # a new (B, T)
        spans = tracing.drain()
    finally:
        tracing.disable()
    assert fd.adm_decode_raw.graph_captures == c0 + 1
    assert fd.adm_decode_raw.graph_replays == r0 + T + 40
    caps = [s for s in spans if s[0] == "adm.capture"]
    assert len(caps) == 1 and caps[0][3] == 40
    assert [s[3] for s in spans if s[0] == "adm.decode"] == [40]
    assert torch.equal(short, _adm_eager(adm, tc[:5, :40]))
    assert (fd.plm_fast_decode.graph_captures, fd.plm_fast_decode.graph_replays) == p0

    # in place: the graph reads the weights where they are, no capture
    head = adm.predict_layer
    with torch.no_grad():
        head.weight.mul_(-1.0)
    flipped = fd.adm_decode_raw(adm, tc)
    assert fd.adm_decode_raw.graph_captures == c0 + 1
    assert torch.equal(flipped, _adm_eager(adm, tc))
    with torch.no_grad():
        head.weight.mul_(-1.0)

    # reassigned: a new address, captured again, reading the new storage
    w = head.weight
    w.data = w.data.flip(1).contiguous()
    got = fd.adm_decode_raw(adm, tc)
    assert fd.adm_decode_raw.graph_captures == c0 + 2
    assert torch.equal(got, _adm_eager(adm, tc))
    w.data = w.data.flip(1).contiguous()
