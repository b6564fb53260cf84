"""The PLM's and ADM's decoder layers: the KV-cached decode loops (port of
``megatts2_tpu/models/fast_decode.py``: greedy or temperature / top-k
sampling, optionally after a prompt prefilled into the caches; the
per-slot tick of the continuous engine, :func:`plm_fast_tick`) and the
full-sequence forward that training and the prompt prefill run (port of
the linear-FF ``TransformerEncoderLayer`` of ``megatts2_tpu/nn/transformer.py``).

Each decoder layer holds ONE merged q/k/v projection (the bridge
concatenates the JAX ``w_q``, ``w_k``, ``w_v`` at load time) and each layer
owns ONE (B, L, 2D) cache: k and v sit side by side in the projection's
output, so a step writes the cache with a single slice assignment of
``qkv[:, D:]``.  The cache is updated in place, which keeps one buffer per
layer for the whole decode.

Numerics follow the JAX loop: LayerNorm statistics in fp32, q·k products
accumulated in fp32 from compute-dtype operands, fp32 softmax, then P·V in
the compute dtype.  A step attends to cache positions ``<= t`` only, which
equals the JAX masked attention over the whole cache, since the masked
positions there carry exactly zero weight.  Every Linear goes through
:func:`dense`, which is ``_dense``: a float layer multiplies in the compute
dtype, a ``QuantLinear`` (int8 or packed int4,
``quantization/weight_only.py``) accumulates in fp32 and applies its fp32
scale and bias before the cast.

On a CUDA device :func:`plm_fast_decode` and :func:`adm_decode_raw` replay
their step as one CUDA graph (:class:`PLMStepGraph`, :class:`ADMStepGraph`):
the step at static shapes is :meth:`DecoderLayer.step_slots` with every row
at one position held on the device, which attends the whole cache masked
above it, the JAX loop's own masked attention.  The graph is captured once
per (B, L, dtype, device) and addresses of the model's parameters and
buffers (:func:`step_graph`).  The PLM's is replayed once a code, the choice
of the code staying outside it; the ADM's feeds its raw prediction back on
the device, so its T replays follow one another with no host work between.
On the CPU the loops run eagerly, one :meth:`DecoderLayer.step` a layer.

The training forward computes in the dtype of its input over fp32 master
weights, with the casts of flax's ``dtype=`` written out: a Dense casts its
weight and bias to the compute dtype, LayerNorm keeps fp32 statistics and
returns the compute dtype, and the residual stream stays in it.  Attention
is the masked flash attention of ``ops/attention.py`` (kernels B and C on
the card) under ``use_flash``, else the additive mask through
``nn/transformer.attend``, as the JAX encoder chooses.  Dropout sits after
the output projection and on the FF hidden, its masks drawn from an
explicit ``torch.Generator`` (``nn/dropout.py``).
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.dropout import Draws, dropout
from ..nn.layers import layer_norm, linear
from ..nn.transformer import attend
from ..ops.attention import flash_attention
from ..ops.masks import NEG_INF, causal_mask, make_attn_mask
from ..parallel.layers import ModelParallel, tp_cols
from ..quantization.weight_only import QuantLinear, qdense
from ..utils import tracing


def dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)`` (weight and bias cast to x's dtype),
    ``QDense`` for a :class:`QuantLinear`, or a tensor-parallel layer's
    forward (``parallel/layers.py``)."""
    if isinstance(layer, QuantLinear):
        return qdense(layer, x)
    if isinstance(layer, ModelParallel):
        return layer(x)
    return linear(layer, x)


class CachedSelfAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)


class DecoderLayer(nn.Module):
    """Pre-LN transformer layer, one token per call (linear FF)."""

    def __init__(self, dim: int, ff_dim: int, n_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CachedSelfAttention(dim, n_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_linear1 = nn.Linear(dim, ff_dim)
        self.ff_linear2 = nn.Linear(ff_dim, dim)

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D) in the compute dtype
        mask: Optional[torch.Tensor],  # additive (B|1, 1, T, T), or None on the flash path
        k_lens: Optional[torch.Tensor],  # (B,) on the flash path
        causal: bool,
        rate: float,
        draws: Optional[Draws],
        ckv: Optional[torch.Tensor] = None,  # (B, L >= T, 2D) cache to prefill
    ) -> torch.Tensor:
        """Pre-LN layer over the whole sequence:
        x + drop(out_proj(attn(norm1 x))), then
        x + linear2(drop(relu(linear1(norm2 x)))).  With ``ckv`` the
        sequence's k and v are written into its first T positions.  Under
        tensor parallelism the layer runs this rank's heads and FF columns
        (``Dl`` = D / n_model features of each of q, k and v)."""
        B, T, D = x.shape
        dh = D // self.attn.n_heads
        qkv = dense(self.attn.qkv, layer_norm(self.norm1, x))  # (B, T, 3Dl): q, k, v side by side
        Dl = qkv.shape[-1] // 3
        if ckv is not None:
            ckv[:, :T] = qkv[..., Dl:]
        q, k, v = (t.view(B, T, Dl // dh, dh) for t in qkv.split(Dl, dim=-1))
        if k_lens is not None:
            att = flash_attention(q, k, v, k_lens, causal)
        else:
            att = attend(q, k, v, mask)
        x = x + dropout(dense(self.attn.out_proj, att.reshape(B, T, Dl)), rate, draws)
        h = dropout(F.relu(dense(self.ff_linear1, layer_norm(self.norm2, x))), rate, draws,
                    cols=tp_cols(self.ff_linear1))
        return x + dense(self.ff_linear2, h)

    def step(self, x: torch.Tensor, ckv: torch.Tensor, t: int) -> torch.Tensor:
        """x (B, D) at position t; writes this token's k and v into ``ckv``
        (B, L, 2D) in place and returns the layer's output (B, D)."""
        B, D = x.shape
        H = self.attn.n_heads
        dh = D // H
        qkv = dense(self.attn.qkv, self.norm1(x))
        ckv[:, t] = qkv[:, D:]
        q = qkv[:, :D].view(B, H, 1, dh)
        k = ckv[:, : t + 1, :D].view(B, t + 1, H, dh).transpose(1, 2)
        v = ckv[:, : t + 1, D:].view(B, t + 1, H, dh).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * dh**-0.5  # (B, H, 1, t+1)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = (probs @ v).reshape(B, D)
        x = x + dense(self.attn.out_proj, ctx)
        return x + dense(self.ff_linear2, F.relu(dense(self.ff_linear1, self.norm2(x))))


    def step_slots(self, x: torch.Tensor, ckv: torch.Tensor, p_abs: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
        """The per-slot step: row s at its own absolute position
        ``p_abs[s]``.  Writes each row's k and v into ``ckv`` (S, L, 2D) at
        its position (``index_put_``) and attends cache positions
        ``<= p_abs[s]`` of the whole cache, masked additively with -1e9 as
        JAX's ``_attend_cached_slots`` (the masked weights are exactly 0).
        ``rows`` is ``arange(S)`` on the device."""
        S, D = x.shape
        H = self.attn.n_heads
        dh = D // H
        L = ckv.shape[1]
        qkv = dense(self.attn.qkv, self.norm1(x))
        ckv.index_put_((rows, p_abs), qkv[:, D:])
        q = qkv[:, :D].view(S, H, 1, dh)
        k = ckv[:, :, :D].view(S, L, H, dh).transpose(1, 2)
        v = ckv[:, :, D:].view(S, L, H, dh).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * dh**-0.5  # (S, H, 1, L)
        keep = torch.arange(L, device=x.device)[None, :] <= p_abs[:, None]
        mask = torch.where(keep, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
        probs = torch.softmax(logits + mask, dim=-1).to(x.dtype)
        ctx = (probs @ v).reshape(S, D)
        x = x + dense(self.attn.out_proj, ctx)
        return x + dense(self.ff_linear2, F.relu(dense(self.ff_linear1, self.norm2(x))))


class DecoderStack(nn.Module):
    def __init__(
        self, dim: int, ff_dim: int, num_layers: int, n_heads: int, dropout: float = 0.0,
        use_flash: bool = False,
    ):
        super().__init__()
        self.dropout = dropout
        self.use_flash = use_flash
        self.layers = nn.ModuleList(DecoderLayer(dim, ff_dim, n_heads) for _ in range(num_layers))

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D) in the compute dtype
        x_lens: Optional[torch.Tensor] = None,  # (B,)
        causal: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        caches: Optional[list[torch.Tensor]] = None,
        draws: Optional[Draws] = None,
    ) -> torch.Tensor:
        """The whole sequence through every layer; the mask is built once from
        the lengths (padding, optionally causal) or, with ``use_flash``,
        passed to the kernel as lengths.  ``caches`` (one per layer, as
        :meth:`new_cache` makes them) receive the sequence's k and v.  In
        train mode the dropout masks come from ``draws``, or from
        ``generator`` without it."""
        B, T = x.shape[0], x.shape[1]
        mask = k_lens = None
        if x_lens is not None:
            if self.use_flash:
                k_lens = x_lens
            else:
                mask = make_attn_mask(x_lens, T, causal=causal)
        elif causal:
            if self.use_flash:
                k_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
            else:
                mask = causal_mask(T, device=x.device)
        draws = (draws or Draws(generator)) if train else None
        for i, layer in enumerate(self.layers):
            x = layer(x, mask, k_lens, causal, self.dropout, draws,
                      None if caches is None else caches[i])
        return x

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the LayerNorms, which every cast takes."""
        return self.layers[0].norm1.weight.dtype

    def new_cache(self, B: int, L: int, like: torch.Tensor) -> list[torch.Tensor]:
        """One zeroed (B, L, 2D) buffer per layer, in ``like``'s dtype and device."""
        D = self.layers[0].norm1.normalized_shape[0]
        return [like.new_zeros(B, L, 2 * D) for _ in self.layers]

    def step(self, x: torch.Tensor, caches: list[torch.Tensor], t: int) -> torch.Tensor:
        for layer, ckv in zip(self.layers, caches):
            x = layer.step(x, ckv, t)
        return x


def plm_fast_tick(
    model,
    tc_plm: torch.Tensor,  # (S, Tc, D_tc) in the compute dtype
    caches: list[torch.Tensor],  # per layer (S, Tc + Pe, 2D)
    codes: torch.Tensor,  # (S, Tc) int64, updated in place
    prev: torch.Tensor,  # (S,) int64 last code of each slot
    pos: torch.Tensor,  # (S,) int64 generated-code position
    plen: torch.Tensor,  # (S,) int64 prompt length (cache offset)
    total: torch.Tensor,  # (S,) int64 codes each slot generates
    K: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance every slot K greedy prosody codes (port of JAX
    ``fast_decode.plm_fast_tick``): row s decodes at position
    ``min(pos[s], Tc - 1)``, absolute cache position ``+ plen[s]``.  A
    finished slot (``pos >= total``) freezes its codes, ``prev`` and
    ``pos``; its cache keeps taking junk writes at the clamped last
    position, which nothing reads.  Returns the new ``(prev, pos)``."""
    S, Tc, _ = tc_plm.shape
    rows = torch.arange(S, device=tc_plm.device)
    dtype = model.plm.dtype
    for _ in range(K):
        p = pos.clamp(max=Tc - 1)
        p_abs = p + plen
        x = torch.cat([tc_plm[rows, p].to(dtype), model.pc_embedding(prev).to(dtype)], dim=-1)
        x = x + model.pe[p_abs].to(dtype)
        for layer, ckv in zip(model.plm.layers, caches):
            x = layer.step_slots(x, ckv, p_abs, rows)
        code = dense(model.predict_layer, x).float().argmax(dim=-1)
        live = pos < total
        codes[rows, p] = torch.where(live, code, codes[rows, p])
        prev = torch.where(live, code, prev)
        pos = torch.where(live, pos + 1, pos)
    return prev, pos


def plm_decode_step(
    model, tc_t: torch.Tensor, prev: torch.Tensor, caches: list[torch.Tensor], t: int
) -> torch.Tensor:
    """One PLM step at absolute position t: tc_t (B, D_tc), previous code
    (B,) → logits (B, vq_bins) fp32."""
    dtype = model.plm.dtype
    x = torch.cat([tc_t.to(dtype), model.pc_embedding(prev).to(dtype)], dim=-1)
    x = x + model.pe[t].to(dtype)
    x = model.plm.step(x, caches, t)
    return dense(model.predict_layer, x).float()


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise as ``jax.random.gumbel`` draws it:
    -log(-log(u)), u uniform in [tiny, 1), from ``generator`` (on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def pick(logits: torch.Tensor, t: int, temperature: float, top_k: int,
         generator: Optional[torch.Generator], gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """The next code from fp32 logits (B, V): argmax when greedy; else
    ``jax.random.categorical`` = argmax(logits / temperature + Gumbel noise),
    the logits under the top_k-th largest set to -1e9 first.  The noise is
    ``gumbel[t]`` when given (tests inject JAX's), else drawn."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    lg = logits / temperature
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, -1e9)
    noise = gumbel[t] if gumbel is not None else gumbel_noise(lg.shape, generator, lg.device)
    return (lg + noise).argmax(dim=-1)


def capture_step(g, model, name: str) -> None:
    """Record ``g.step(model)`` as the CUDA graph ``g.graph`` after one
    warm-up step, both on a side stream, inside the span ``name`` (``n`` =
    the cache's length).  Each step writes the cache and advances ``g.pos``,
    which the decode resets."""
    with tracing.span(name, g.cache.shape[2]), torch.cuda.device(g.cache.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            g.step(model)
        torch.cuda.current_stream().wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, stream=side):
            g.step(model)


class PLMStepGraph:
    """One PLM decode step at static shapes, B rows over a cache of L
    positions, and the buffers it reads and writes: the caches (one
    (layers, B, L, 2D) buffer, ``caches`` its per-layer views), the position
    ``pos`` (B,), the step's content latent ``tc_t`` and previous code
    ``prev``, and the fp32 ``logits`` it leaves.  :meth:`capture` records
    :meth:`step` as a CUDA graph; :meth:`decode` replays it once a code, or
    runs :meth:`step` where nothing was captured.  It holds no reference to
    the model, whose weights the graph reads at the addresses of its
    capture."""

    @staticmethod
    def stack(model) -> DecoderStack:
        return model.plm

    def __init__(self, model, B: int, L: int, device: torch.device):
        dtype = model.plm.dtype
        D = model.cfg.d_model
        self.cache = torch.zeros(len(model.plm.layers), B, L, 2 * D, dtype=dtype, device=device)
        self.caches = list(self.cache.unbind(0))
        self.pos = torch.zeros(B, dtype=torch.long, device=device)
        self.rows = torch.arange(B, device=device)
        self.tc_t = torch.zeros(B, model.cfg.tc_latent_dim, dtype=dtype, device=device)
        self.prev = torch.zeros(B, dtype=torch.long, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def step(self, model) -> None:
        """:func:`plm_decode_step` at position ``pos`` through
        :meth:`DecoderLayer.step_slots` (the whole cache, masked above the
        position), then ``pos`` advanced by one."""
        dtype = self.cache.dtype
        x = torch.cat([self.tc_t, model.pc_embedding(self.prev).to(dtype)], dim=-1)
        x = x + model.pe[self.pos].to(dtype)
        for layer, ckv in zip(model.plm.layers, self.caches):
            x = layer.step_slots(x, ckv, self.pos, self.rows)
        self.pos += 1
        self.logits = dense(model.predict_layer, x).float()

    def capture(self, model) -> None:
        """:func:`capture_step` in the span ``plm.capture``."""
        capture_step(self, model, "plm.capture")
        plm_fast_decode.graph_captures += 1

    def decode(self, model, tc: torch.Tensor, temperature: float, top_k: int,
               generator: Optional[torch.Generator], gumbel: Optional[torch.Tensor],
               init_cache: Optional[list[torch.Tensor]], start_pos: int,
               prev0: Optional[torch.Tensor]) -> torch.Tensor:
        """:func:`plm_fast_decode`'s codes (B, T) for tc (B, T, D_tc) in the
        compute dtype, T = L - ``start_pos``: the caches zeroed or the
        prompt's copied in, then a step and a :func:`pick` a code."""
        if init_cache is None:
            self.cache.zero_()
        else:
            for dst, src in zip(self.caches, init_cache):
                dst.copy_(src[:, : dst.shape[1]])
        self.pos.fill_(start_pos)
        if prev0 is None:
            self.prev.fill_(model.cfg.bos_id)
        else:
            self.prev.copy_(prev0)
        if self.graph is None:
            run = functools.partial(self.step, model)
        else:
            run = self.graph.replay
            plm_fast_decode.graph_replays += tc.shape[1]
        codes = []
        for t in range(tc.shape[1]):
            self.tc_t.copy_(tc[:, t])
            run()
            code = pick(self.logits, t, temperature, top_k, generator, gumbel)
            self.prev.copy_(code)
            codes.append(code)
        return torch.stack(codes, dim=1)


class ADMStepGraph:
    """One ADM decode step at static shapes, B rows over a cache of L = T
    positions, and the buffers it reads and writes: the caches (one
    (layers, B, L, 2D) buffer, ``caches`` its per-layer views), the position
    ``pos`` (B,), the whole content latent ``tc`` (B, L, D_tc) in the
    compute dtype, the fed-back raw prediction ``prev`` (B,) fp32 and the
    raw predictions ``out`` (B, L) fp32.  :meth:`capture` records
    :meth:`step` as a CUDA graph; :meth:`decode` replays it T times, or runs
    :meth:`step` where nothing was captured.  Like :class:`PLMStepGraph` it
    holds no reference to the model."""

    @staticmethod
    def stack(model) -> DecoderStack:
        return model.adm

    def __init__(self, model, B: int, L: int, device: torch.device):
        dtype = model.adm.dtype
        D = model.cfg.d_model
        self.cache = torch.zeros(len(model.adm.layers), B, L, 2 * D, dtype=dtype, device=device)
        self.caches = list(self.cache.unbind(0))
        self.pos = torch.zeros(B, dtype=torch.long, device=device)
        self.rows = torch.arange(B, device=device)
        self.tc = torch.zeros(B, L, model.cfg.tc_latent_dim, dtype=dtype, device=device)
        self.prev = torch.zeros(B, dtype=torch.float32, device=device)
        self.out = torch.zeros(B, L, dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def step(self, model) -> None:
        """One step of :func:`adm_decode_raw`'s loop at position ``pos``
        through :meth:`DecoderLayer.step_slots` (the whole cache, masked
        above the position): its raw prediction into ``prev`` and
        ``out[:, pos]``, then ``pos`` advanced by one."""
        dtype = self.cache.dtype
        dt_emb = dense(model.dt_linear_emb, self.prev[:, None].to(dtype))
        x = torch.cat([dense(model.tc_linear_emb, self.tc[self.rows, self.pos]), dt_emb], dim=-1)
        x = x + model.pe[self.pos].to(dtype)
        for layer, ckv in zip(model.adm.layers, self.caches):
            x = layer.step_slots(x, ckv, self.pos, self.rows)
        self.prev.copy_(dense(model.predict_layer, x)[:, 0].float())
        self.out.index_put_((self.rows, self.pos), self.prev)
        self.pos += 1

    def capture(self, model) -> None:
        """:func:`capture_step` in the span ``adm.capture``."""
        capture_step(self, model, "adm.capture")
        _adm_counts.graph_captures += 1

    def decode(self, model, tc: torch.Tensor) -> torch.Tensor:
        """:func:`adm_decode_raw`'s predictions (B, T) for tc (B, T, D_tc)
        in the compute dtype, T = L: the caches, ``prev`` and ``pos``
        zeroed, ``tc`` copied in, then T steps.  Returns a copy of ``out``,
        which the next decode overwrites."""
        self.cache.zero_()
        self.prev.zero_()
        self.pos.zero_()
        self.tc.copy_(tc)
        T = tc.shape[1]
        if self.graph is None:
            for _ in range(T):
                self.step(model)
        else:
            for _ in range(T):
                self.graph.replay()
            _adm_counts.graph_replays += T
        return self.out.clone()


GRAPHS_KEPT = 8  # captured steps kept a model; the least recently used goes first
_graphs: "weakref.WeakKeyDictionary[nn.Module, collections.OrderedDict]" = \
    weakref.WeakKeyDictionary()
_graphs_lock = threading.Lock()  # the graphs' buffers serve one decode at a time


def step_graph(model, B: int, L: int, device: torch.device, kind: type = PLMStepGraph):
    """The captured step of ``model`` (a ``kind``: :class:`PLMStepGraph` or
    :class:`ADMStepGraph`) for B rows and L positions on ``device``,
    captured at its first use.  Besides the shapes, the compute dtype and
    the device, the key holds the address of every parameter and buffer of
    the model: a weight reassigned (``p.data = ...``, a cast) captures anew,
    while one updated in place (``load_state_dict``, an optimizer step)
    keeps its graph, which reads it where it is.  The caller holds
    ``_graphs_lock``."""
    key = (B, L, kind.stack(model).dtype, device,
           tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers())))
    graphs = _graphs.setdefault(model, collections.OrderedDict())
    g = graphs.pop(key, None)
    if g is None:
        g = kind(model, B, L, device)
        g.capture(model)
    graphs[key] = g
    while len(graphs) > GRAPHS_KEPT:
        graphs.popitem(last=False)
    return g


@torch.inference_mode()
def plm_fast_decode(
    model,
    tc_latent: torch.Tensor,  # (B, T, D_tc)
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # (T, B, vq_bins) injected noise
    init_cache: Optional[list[torch.Tensor]] = None,  # per layer (B, >= start_pos + T, 2D)
    start_pos: int = 0,  # first decode position (the prompt's length)
    prev0: Optional[torch.Tensor] = None,  # (B,) first input code, BOS by default
) -> torch.Tensor:
    """Prosody codes for every one of the T steps: tc_latent (B, T, D_tc) →
    (B, T) int64.  Greedy unless ``temperature > 0``, which needs a
    ``generator`` on the model's device or injected ``gumbel`` noise.
    ``init_cache``/``start_pos``/``prev0`` carry a prompt prefilled by
    ``MegaPLM.prefill``.  On a CUDA device the step is a replayed CUDA graph
    (:func:`step_graph`); counters: ``plm_fast_decode.graph_captures``,
    ``plm_fast_decode.graph_replays`` (steps)."""
    B, T, _ = tc_latent.shape
    if temperature > 0 and generator is None and gumbel is None:
        raise ValueError("sampling (temperature > 0) needs a generator or injected gumbel noise")
    tc = tc_latent.to(model.plm.dtype)
    if tc.is_cuda:
        with _graphs_lock, tracing.span("plm.decode", T):
            return step_graph(model, B, start_pos + T, tc.device).decode(
                model, tc, temperature, top_k, generator, gumbel, init_cache, start_pos, prev0)
    caches = init_cache if init_cache is not None else model.plm.new_cache(B, start_pos + T, tc)
    prev = prev0 if prev0 is not None else torch.full(
        (B,), model.cfg.bos_id, dtype=torch.long, device=tc.device)
    codes = []
    with tracing.span("plm.decode", T):
        for t in range(T):
            logits = plm_decode_step(model, tc[:, t], prev, caches, start_pos + t)
            prev = pick(logits, t, temperature, top_k, generator, gumbel)
            codes.append(prev)
    return torch.stack(codes, dim=1)


plm_fast_decode.graph_captures = 0
plm_fast_decode.graph_replays = 0


@torch.inference_mode()
def adm_decode_raw(model, tc_latents: torch.Tensor) -> torch.Tensor:
    """Raw duration predictions (B, T) fp32.  Each step feeds back the
    previous RAW float prediction (0 at the first step), as the reference
    loop does.  Int8 / int4 layers take the quantized dense.  On a CUDA
    device the step is a replayed CUDA graph (:class:`ADMStepGraph`, from
    :func:`step_graph`); counters: ``adm_decode_raw.graph_captures``,
    ``adm_decode_raw.graph_replays`` (steps)."""
    B, T, _ = tc_latents.shape
    dtype = model.adm.dtype
    tc = tc_latents.to(dtype)
    if tc.is_cuda:
        with _graphs_lock, tracing.span("adm.decode", T):
            return step_graph(model, B, T, tc.device, ADMStepGraph).decode(model, tc)
    caches = model.adm.new_cache(B, T, tc)
    prev = torch.zeros(B, dtype=torch.float32, device=tc.device)
    out = []
    with tracing.span("adm.decode", T):
        for t in range(T):
            dt_emb = dense(model.dt_linear_emb, prev[:, None].to(dtype))
            x = torch.cat([dense(model.tc_linear_emb, tc[:, t]), dt_emb], dim=-1)
            x = model.adm.step(x + model.pe[t].to(dtype), caches, t)
            prev = dense(model.predict_layer, x)[:, 0].float()
            out.append(prev)
    return torch.stack(out, dim=1)


adm_decode_raw.graph_captures = 0
adm_decode_raw.graph_replays = 0
_adm_counts = adm_decode_raw  # the counters' owner, whatever later rebinds the module's name


def adm_fast_decode(model, tc_latents: torch.Tensor) -> torch.Tensor:
    """Greedy durations (B, T) int64: raw + 0.5, truncated, clamped to
    [1, max_duration_token]."""
    raw = adm_decode_raw(model, tc_latents)
    return torch.clamp((raw + 0.5).to(torch.int32), 1, model.cfg.max_duration_token).long()
