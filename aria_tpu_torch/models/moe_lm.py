"""The Aria MoE decoder (counterpart of aria_tpu/models/moe_lm.py): the
serving forms and training.

Parameters are the JAX package's tree, leaf for leaf (see
``checkpoint/from_jax.py``): every per-layer leaf is stacked on a leading
[L] axis and linear weights are right-multiply [in, out]. The training
tree (``init_lm_params``) is float with the shared experts as their own
MLP (``shared_w1``, ``shared_w2``); the serving forms fuse them into the
expert stacks as always-on experts:

- int4 (``init_lm_params_serving_int4``): dense int4 wqkv/wo ``{"q4t",
  "sg"}``, int4 expert stacks, int8 ``{"q", "s"}`` embed and lm_head;
- int8 (bench.py without ``--int4``: ``quantize_params``, then
  ``fuse_shared_experts``): int8 wqkv/wo and lm_head, int8 experts with
  ``"s8"``, bf16 embed;
- bf16 (the same with ``--bf16``): every weight bf16.

The layer loop is a Python loop over a layer index; the kernels index the
whole weight and cache stacks with it, so no per-layer slice is copied.
Attention has two kernel branches: causal flash over the fresh
k/v of a from-zero prefill (and of training, where autograd runs its
backward kernel), and decode attention over the cache for one new token.
Several new tokens a lane over the cache (the speculative verify step,
moe_lm.py:617-642) attend the layer's cache plane in plain torch, as the
JAX package attends it in XLA, with the decode kernel's roundings
(``cached_attention_plain``);
wqkv/wo go through ``dense_int4`` in the int4 form and through ``linear``
(an f32 torch product, as the JAX package leaves it to XLA) in the others.
The MoE (moe_lm.py:929-1044) takes, in serving, up to 128 tokens, the
decode kernel of the form (``moe_decode_int4``, W4A8 unless ``MOE_A8`` is
off, ``moe_decode_quant``, ``moe_decode``); above that the int4 form takes
the segmented prefill kernel, and the others dequantize the layer's
experts (int8 only, for this call) and take the ragged path
(``experts_ragged``, two ``gmm`` kernels).
In training, and wherever expert LoRA is given, the MoE is the JAX
package's XLA dispatch: expert LoRA on the capacity path
(``experts_grouped``; over quantized experts one block of experts at a
time, dequantized by the ``expert_block_dequant`` kernel, with the
multi-adapter selector of multi-LoRA serving), at most 32 tokens on
``experts_gather``, more on
``experts_ragged`` when there are more than 2 x top-k experts (its
backward is ``gmm_dlhs`` and ``tgmm``), else ``experts_grouped``; the
router adds its z and aux losses, and there is no MoE slicing. LoRA
adapters (``train/lora.py``) add their deltas to wqkv, wo, shared_w1 and
shared_w2 and ride inside the expert GLU. ``remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) as ``jax.checkpoint`` does the
scanned body. Training over int8 experts is QLoRA (the JAX package's
``quantize_params`` tree): with expert LoRA the blocked path above, else
the layer's experts dequantized for the training dispatch; the frozen
base's dequantized weights are constants, and each block (or layer) runs
under a non-reentrant checkpoint so that the backward dequantizes it again
instead of keeping it (``_frozen_base``). An attention ``mask`` (True =
attend) replaces the causal mask of uncached attention: the plain masked
``sdpa`` runs with autograd, as the JAX package leaves it to XLA. The KV
cache (bf16, int8, or head-pair packed int4) is written in place: at one
offset for every lane, or at a per-lane offset (continuous batching). A
decode step (one new token per lane), a from-zero prefill and a per-lane
write of several positions (the verify step) take the fused prologue
``rope_kv_write``: one kernel a layer turns the wqkv output into the
rotated, quantized cache write and the rotated query (with the fresh k, v
for flash). The writers of a mesh over ``model``
or ``context`` keep the chain of ``apply_rope``, ``quantize_kv`` and an
indexed write or the ``kv_cache_write`` kernel; on a mesh with neither the
cache is whole and the prologue stays.

Over a mesh's ``expert`` axis the MoE is expert-parallel
(``_moe_ffn_ep``, ``parallel/ep.py``); in training over ``fsdp`` each
layer's weights are gathered whole just before it runs
(``parallel/fsdp.py``).

With a ``page_table`` the cache is the paged server's ``PagedKVCache``
(moe_lm.py:382-428): one new token per lane is written by
``rope_kv_write`` with rows = page ids and attends through the
``paged_decode_attention`` kernel; a prefill chunk of C tokens per lane is
written by an indexed write and attends the lanes' gathered, dequantized
pages with the plain ``sdpa`` under the chunk's causal mask, as the JAX
package attends them in XLA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from aria_tpu_torch.config import TextConfig
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops.attention import sdpa
from aria_tpu_torch.ops.decode_attention import cached_attention_plain, decode_attention
from aria_tpu_torch.ops.dense_int4 import dense_int4
from aria_tpu_torch.ops.expert_dequant import expert_block_dequant
from aria_tpu_torch.ops.flash import flash_causal
from aria_tpu_torch.ops.kv_write import kv_cache_write, quantize_kv, rope_kv_write
from aria_tpu_torch.ops.moe import (
    experts_gather,
    experts_grouped,
    experts_ragged,
    glu,
    route_topk,
    router_logits,
)
from aria_tpu_torch.ops.moe_decode_kernel import (
    DECODE_KERNEL_MAX_TOKENS,
    moe_decode,
    moe_decode_int4,
    moe_decode_quant,
)
from aria_tpu_torch.ops.moe_prefill_kernel import experts_segmented_int4
from aria_tpu_torch.ops.norms import rms_norm
from aria_tpu_torch.ops.paged_attention import (
    gather_lane_kv,
    paged_decode_attention,
    paged_write,
    write_index,
)
from aria_tpu_torch.ops.quant import (
    dequantize_expert_weights,
    is_dense_int4,
    is_quantized,
    is_quantized_int4,
    linear,
    quantize_dense_int4,
    quantize_expert_int4,
    quantize_weight,
    with_s8,
)
from aria_tpu_torch.ops.rope import apply_rope, precompute_rope
from aria_tpu_torch.parallel.cp_cache import (
    cp_cached_prefill_attention,
    local_cache_shape,
    mesh_decode_attention,
)


MOE_CHUNK = 8192  # tokens per MoE slice of a long prefill (moe_lm.py:866-880)
MOE_CHUNK_LONG = 2048  # the slice from 32768 tokens on
LORA_EBLOCK = 0  # experts per block of _experts_lora_blocked where it divides E; 0: default
# The JAX package's off-by-default A/B switches, read at call time, with its
# defaults: W4A8 wqkv / wo for a step of at most 32 rows (ARIA_TPU_DENSE_A8,
# moe_lm.py:331-335); the W4A8 int4 decode MoE, False for bf16 activations
# (ARIA_TPU_A8, moe_lm.py:962-973). The ViT's is models/vit.py's VIT_FLASH.
DENSE_A8 = False
MOE_A8 = True


@dataclasses.dataclass
class KVCache:
    """Static-shape cache [L, B, H_kv, S_max, D_head]: bf16; or int8 with
    f32 per-(layer, lane, head, position) scales (amax/127 over D at write
    time); or ``"int4"``, head pairs nibble-packed into an int8 [L, B,
    H_kv/2, S_max, D_head] buffer (head h in the low nibble as value + 8,
    head h + H_kv/2 in the high one) with bf16 scales [L, B, H_kv, S_max]
    (amax/7), as moe_lm.py:83-108. Written in place by ``lm_forward``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(cfg: TextConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
             device="cuda", mesh=None) -> "KVCache":
        """On the card unless ``device`` names another. With a serving
        ``mesh`` (``parallel/mesh.py``), this rank's block: heads over
        ``model`` (all of them for int4, whose bytes pair heads), positions
        over ``context``."""
        device = backend.device(device)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
        if dtype == "int4":
            if cfg.num_kv_heads % 2:
                raise ValueError("an int4 KV cache packs head pairs: the head count must be even")
            shape = local_cache_shape(shape, mesh, packed4=True)
            pshape = shape[:2] + (cfg.num_kv_heads // 2,) + shape[3:]
            return KVCache(torch.zeros(pshape, dtype=torch.int8, device=device),
                           torch.zeros(pshape, dtype=torch.int8, device=device),
                           torch.ones(shape[:-1], dtype=torch.bfloat16, device=device),
                           torch.ones(shape[:-1], dtype=torch.bfloat16, device=device))
        shape = local_cache_shape(shape, mesh, packed4=False)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        if dtype == torch.int8:
            return KVCache(k, v, torch.ones(shape[:-1], device=device),
                           torch.ones(shape[:-1], device=device))
        return KVCache(k, v)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed4(self) -> bool:
        """int4 head-pair packing: the scales have twice the head planes."""
        return self.k_scale is not None and self.k_scale.shape[2] == 2 * self.k.shape[2]

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


class LMOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # [B, S, V] f32 (None with head=False)
    cache: Optional[KVCache]
    z_loss: Optional[torch.Tensor] = None  # f32 scalars, summed over layers
    aux_loss: Optional[torch.Tensor] = None
    hidden: Optional[torch.Tensor] = None  # [B, S, D] after the final norm (head=False)

# Up to this many tokens the training MoE gathers each token's experts
# (moe_lm.py:46).
GATHER_PATH_MAX_TOKENS = 32


def _dense_init(generator, device, dtype):
    """Draws of the JAX init's ``dense``: N(0, 1) in f32 times
    scale_dim**-0.5, cast to ``dtype``."""
    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale_dim**-0.5).to(dtype)
    return dense


def init_lm_params(cfg: TextConfig, generator: torch.Generator, *, device="cuda",
                   dtype=torch.bfloat16, mesh=None) -> dict:
    """Random-init the training tree of moe_lm.py:122-146, on the card unless
    ``device`` names another: float weights, the router gate f32, the
    shared experts unfused. Each [L, ...] stack is drawn one layer at a
    time, so the f32 draws never hold a whole stack (a full-width w1 is 15
    G weights). With a ``mesh`` each leaf (each layer of a stack) is cut to
    this rank's shard by ``lm_param_specs`` as soon as it is drawn
    (``mesh.shard_leaf``); the draws are those of the whole tree."""
    from aria_tpu_torch.parallel.mesh import P, lm_param_specs, shard_leaf

    device = backend.device(device)
    L, D, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    I, Is = cfg.moe_intermediate_size, cfg.shared_intermediate_size
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dense = _dense_init(generator, device, dtype)
    specs = lm_param_specs()

    def cut(t, spec):
        return t if mesh is None else shard_leaf(t, spec, mesh)

    def stack(name, shape, scale_dim, out_dtype=dtype):
        spec = P(*specs["layers"][name][1:])
        out = None
        for layer in range(L):
            piece = cut(dense(shape, scale_dim), spec).to(out_dtype)
            if out is None:
                out = torch.empty((L,) + piece.shape, dtype=out_dtype, device=device)
            out[layer] = piece
        return out

    def ones(name, shape):
        return cut(torch.ones((L,) + shape, dtype=dtype, device=device), specs["layers"][name])

    return {
        "embed": cut(dense((cfg.vocab_size, D), D), specs["embed"]),
        "layers": {
            "attn_norm": ones("attn_norm", (D,)),
            "ffn_norm": ones("ffn_norm", (D,)),
            "wqkv": stack("wqkv", (D, qkv_out), D),
            "wo": stack("wo", (cfg.q_size, D), cfg.q_size),
            "gate": stack("gate", (E, D), D, torch.float32),
            "w1": stack("w1", (E, 2 * I, D), D),
            "w2": stack("w2", (E, I, D), I),
            "shared_w1": stack("shared_w1", (D, 2 * Is), D),
            "shared_w2": stack("shared_w2", (Is, D), Is),
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": cut(dense((D, cfg.vocab_size), D), specs["lm_head"]),
    }


def _expert_stacks(cfg: TextConfig, dense, quantize, device, fuse_shared: bool = True,
                   keep: Optional[tuple] = None) -> tuple:
    """The [L, E (+ ns fused), ...] expert stacks, drawn and quantized in
    slabs of at most 11 experts so that no float stack is ever whole:
    ``quantize`` maps a slab (w1 [n, 2I, D], w2 [n, I, D]) to two dicts of
    leaves, which fill stacks allocated at the first slab. ``keep`` (start,
    count) keeps only those experts: every slab is still drawn, in the same
    order, so the kept experts are the whole stack's."""
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.moe_intermediate_size
    E_t = cfg.num_experts + (cfg.num_shared_experts if fuse_shared else 0)
    k0, kn = keep if keep is not None else (0, E_t)
    chunk = next(d for d in range(11, 0, -1) if E_t % d == 0)
    w1 = w2 = None
    for l in range(L):
        for e0 in range(0, E_t, chunk):
            a1, a2 = dense((chunk, 2 * I, D), D), dense((chunk, I, D), I)
            lo, hi = max(e0, k0), min(e0 + chunk, k0 + kn)
            if lo >= hi:
                continue
            q1, q2 = quantize(a1[lo - e0:hi - e0], a2[lo - e0:hi - e0])
            if w1 is None:
                w1, w2 = ({k: torch.empty((L, kn) + v.shape[1:], dtype=v.dtype, device=device)
                           for k, v in q.items()} for q in (q1, q2))
            for dst, src in ((w1, q1), (w2, q2)):
                for leaf, v in src.items():
                    dst[leaf][l, lo - k0:hi - k0] = v
    return w1, w2


def init_lm_params_serving_int4(
    cfg: TextConfig,
    generator: torch.Generator,
    *,
    fuse_shared: bool = True,
    mesh=None,
    device="cuda",
    dtype=torch.bfloat16,
) -> dict:
    """Random-init the decoder directly in its serving form, on the card
    unless ``device`` names another:
    int4 expert stacks, int4 wqkv/wo, int8 embed and lm_head (the structure
    of moe_lm.py:149-252, quantized by the port's own quantizers). The
    shared experts are fused into the stacks, or with ``fuse_shared=False``
    kept as their own int8 MLP (``shared_w1``, ``shared_w2``), the form an
    expert mesh serves. With a ``mesh`` whose ``expert`` axis is above 1,
    the stacks hold only this rank's experts (its block of dim 1, as
    ``serving_param_specs`` shards them); the other leaves are whole and
    every draw is made as without the mesh. Expert weights are drawn and
    quantized in slabs of at most 11 experts, so the bf16 stacks are never
    whole."""
    device = backend.device(device)
    L, D, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dense = _dense_init(generator, device, dtype)
    E_t = E + (cfg.num_shared_experts if fuse_shared else 0)
    keep = None
    if mesh is not None and mesh.shape["expert"] > 1:
        keep = mesh.block("expert", E_t)
    w1, w2 = _expert_stacks(cfg, dense, quantize_expert_int4, device, fuse_shared, keep)

    def dense_int4_stack(d_in, d_out):
        parts = [quantize_dense_int4(dense((1, d_in, d_out), d_in)) for _ in range(L)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "ffn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wqkv": dense_int4_stack(D, qkv_out),
        "wo": dense_int4_stack(cfg.q_size, D),
        "gate": dense((L, E, D), D).float(),
        "w1": w1,
        "w2": w2,
    }
    if not fuse_shared:
        Is = cfg.shared_intermediate_size
        layers["shared_w1"] = quantize_weight(dense((L, D, 2 * Is), D))
        layers["shared_w2"] = quantize_weight(dense((L, Is, D), Is))
    return {
        "embed": quantize_weight(dense((cfg.vocab_size, D), D)),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": quantize_weight(dense((D, cfg.vocab_size), D)),
    }


def init_lm_params_serving(
    cfg: TextConfig,
    generator: torch.Generator,
    *,
    form: str = "bf16",
    device="cuda",
    dtype=torch.bfloat16,
) -> dict:
    """Random-init the decoder in the bf16 or the int8 serving form, on the
    card unless ``device`` names another: the tree that bench.py builds
    without ``--int4`` (bench.py:410-425: ``init_aria_params``, for int8
    ``quantize_params``, then ``fuse_shared_experts``), with the shared
    experts drawn as expert-shaped slabs straight into the fused [L, E +
    ns, ...] stacks, at most 11 experts at a time, so neither a second
    stack nor a whole float one is ever held. int8: wqkv, wo and lm_head
    ``{"q", "s"}``, w1 quantized over D and w2 over I with ``"s8"``; embed
    stays float in both forms."""
    if form not in ("bf16", "int8"):
        raise ValueError(f"form {form!r}: 'bf16' or 'int8'")
    device = backend.device(device)
    L, D, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dense = _dense_init(generator, device, dtype)
    int8 = form == "int8"

    def experts(w1, w2):
        if int8:
            return (with_s8(quantize_weight(w1, input_axis=-1)),
                    with_s8(quantize_weight(w2, input_axis=-2)))
        return {"w": w1}, {"w": w2}

    def proj(w):
        return quantize_weight(w, input_axis=-2) if int8 else w

    w1, w2 = _expert_stacks(cfg, dense, experts, device)
    if not int8:
        w1, w2 = w1["w"], w2["w"]
    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "ffn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wqkv": proj(dense((L, D, qkv_out), D)),
        "wo": proj(dense((L, cfg.q_size, D), cfg.q_size)),
        "gate": dense((L, E, D), D).float(),
        "w1": w1,
        "w2": w2,
    }
    return {
        "embed": dense((cfg.vocab_size, D), D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": proj(dense((D, cfg.vocab_size), D)),
    }


def embed_tokens(embed, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding lookup; an int8 table is dequantized per gathered row."""
    if is_quantized(embed):
        out = embed["q"][tokens].float() * embed["s"]
        return out.to(dtype or torch.bfloat16)
    return embed[tokens]


class _Block(NamedTuple):
    """This rank's block of a cache sharded over a serving mesh: heads
    [h0, h0 + heads), positions [s0, s0 + the cache's S) of ``max_seq``."""
    h0: int
    heads: int
    s0: int
    max_seq: int


def _cache_block(cache: KVCache, cfg: TextConfig, mesh) -> _Block:
    if mesh is None:
        return _Block(0, cfg.num_kv_heads, 0, cache.max_seq)
    h0, heads = (0, cfg.num_kv_heads) if cache.packed4 else mesh.block(
        "model", cfg.num_kv_heads)
    cp_n = mesh.shape["context"]
    return _Block(h0, heads, mesh.coords["context"] * cache.max_seq, cp_n * cache.max_seq)


def _write_cache(cache: KVCache, layer: int, pos, k: torch.Tensor, v: torch.Tensor,
                 rows: Optional[torch.Tensor], block: Optional[_Block] = None):
    """Write k/v [B, S, H, D] of layer ``layer`` in place: at positions
    pos..pos+S of every lane for an int ``pos`` (moe_lm.py:472-482), or at
    pos[b]..pos[b]+S of lane b for a [B] int32 tensor (moe_lm.py:483-532):
    one position per lane through ``kv_cache_write`` (``rows`` the lane
    ids), more by an indexed write.

    On a mesh the cache is this rank's ``block``: only its heads are
    written, and only the positions that fall in it, at the local offset; a
    decode token lands on the rank that owns its position (the kernel and
    its plain version skip a slot outside the block), as the JAX package's
    GSPMD scatter places it."""
    B, S = k.shape[:2]
    if block is None:
        block = _Block(0, k.shape[2], 0, cache.max_seq)
    hs = slice(block.h0, block.h0 + block.heads)
    kq, vq, ks, vs = quantize_kv(cache, k[:, :, hs].transpose(1, 2),
                                 v[:, :, hs].transpose(1, 2))  # [B, H, S, D]
    if not isinstance(pos, torch.Tensor):
        if pos + S > block.max_seq:
            raise ValueError(f"cache write at {pos}+{S} past max_seq {block.max_seq}")
        lo, hi = max(pos, block.s0), min(pos + S, block.s0 + cache.max_seq)
        if lo >= hi:
            return
        src, dst = slice(lo - pos, hi - pos), slice(lo - block.s0, hi - block.s0)
        cache.k[layer, :, :, dst] = kq[:, :, src]
        cache.v[layer, :, :, dst] = vq[:, :, src]
        if cache.quantized:
            cache.k_scale[layer, :, :, dst] = ks[:, :, src]
            cache.v_scale[layer, :, :, dst] = vs[:, :, src]
        return
    if S == 1:
        scales = (cache.k_scale, cache.v_scale, ks[..., 0].contiguous(),
                  vs[..., 0].contiguous()) if cache.quantized else ()
        slots = pos - block.s0 if block.s0 else pos
        kv_cache_write(cache.k, cache.v, layer, rows, slots, kq[:, :, 0].contiguous(),
                       vq[:, :, 0].contiguous(), *scales)
        return
    if block.max_seq != cache.max_seq:
        raise NotImplementedError("a per-lane write of several positions into a cache "
                                  "sharded by position is not ported")
    # positions must lie inside the cache here: an index past it raises
    dev = k.device
    bi = torch.arange(B, device=dev)[:, None, None]
    si = (pos.long()[:, None] + torch.arange(S, device=dev)[None, :])[:, None, :]
    hv = torch.arange(kq.shape[1], device=dev)[None, :, None]
    cache.k[layer, bi, hv, si] = kq
    cache.v[layer, bi, hv, si] = vq
    if cache.quantized:
        hs = torch.arange(ks.shape[1], device=dev)[None, :, None]
        cache.k_scale[layer, bi, hs, si] = ks
        cache.v_scale[layer, bi, hs, si] = vs


def _paged_attention(cache, layer: int, q, lengths, page_table, mask):
    """Attend the lanes' just-written pages (moe_lm.py:382-428): one token
    per lane through the paged kernel, a chunk over the gathered pages
    under ``mask``."""
    if q.shape[1] == 1:
        return paged_decode_attention(q[:, 0], cache, layer, page_table, lengths)[:, None]
    k_att, v_att = gather_lane_kv(cache, layer, page_table)  # [B, H, MAXP * PS, D]
    return sdpa(q, k_att.transpose(1, 2).to(q.dtype), v_att.transpose(1, 2).to(q.dtype), mask)


def _prologue_dest(cache, cache_pos, rows, B: int, S: int, paged, mesh, device):
    """Where ``rope_kv_write`` writes each token, (rows, slots) int32 [B *
    S]: an S == 1 decode step's lanes (``rows``, at per-lane positions) or
    pages (from ``write_index``); lane b's S tokens at cache_pos[b] + s for
    per-lane positions (the verify step: a slot past the cache is dropped,
    the engine's slack check keeps every slot inside); every lane's at
    cache_pos + s for one offset. None where the chain stays: no cache, a
    mesh over model or context (its block's heads and positions), a paged
    chunk."""
    if cache is None or mesh is not None:
        return None
    if paged is not None:
        return (paged[1].reshape(-1), paged[2].reshape(-1)) if S == 1 else None
    lanes = torch.arange(B, dtype=torch.int32, device=device)
    steps = torch.arange(S, dtype=torch.int32, device=device)
    if isinstance(cache_pos, torch.Tensor):
        if S == 1:
            return rows, cache_pos
        return lanes.repeat_interleave(S), (cache_pos[:, None] + steps[None, :]).reshape(-1)
    if cache_pos + S > cache.max_seq:
        raise ValueError(f"cache write at {cache_pos}+{S} past max_seq {cache.max_seq}")
    return lanes.repeat_interleave(S), (cache_pos + steps).repeat(B)


def _layer_weight(w, layer: int):
    """One layer of a stacked weight: a tensor, or an int8 ``{"q", "s"}``
    dict (the kernels' ``s8`` left out)."""
    return {k: w[k][layer] for k in ("q", "s")} if is_quantized(w) else w[layer]


def _project(x2d: torch.Tensor, w, layer: int) -> torch.Tensor:
    """x [T, in] through one layer of wqkv or wo, in f32: a dense int4
    stack through its kernel (W4A8 for at most 32 rows under ``DENSE_A8``,
    moe_lm.py:320-345), an int8 or float one through ``linear``
    (moe_lm.py:368-369)."""
    if is_dense_int4(w):
        a8 = DENSE_A8 and x2d.shape[0] <= 32  # decode steps only (moe_lm.py:334)
        return dense_int4(x2d, w, layer, act_int8=a8)
    return linear(x2d, _layer_weight(w, layer))


def _lora_delta(x: torch.Tensor, ab: Optional[dict], layer: int, scale: float,
                onehot: Optional[torch.Tensor] = None):
    """One layer's LoRA delta x @ a @ b * scale in x's dtype (moe_lm.py:262-277),
    the products in f32. Stacked factors (a [A, d, r]) with ``onehot``
    compute every adapter's delta and select one per row: [A, B] over the
    rows of x [B, S, d], or [A, T] over the tokens of x [T, d]."""
    a, b = ab["a"][layer].float(), ab["b"][layer].float()
    if onehot is not None and a.dim() == 3:
        if x.dim() == 2:
            out = torch.einsum("atr,arf->atf", torch.einsum("td,adr->atr", x.float(), a), b)
            return scale * torch.einsum("atf,at->tf", out, onehot.float()).to(x.dtype)
        out = torch.einsum("absr,arf->absf", torch.einsum("bsd,adr->absr", x.float(), a), b)
        return scale * torch.einsum("absf,ab->bsf", out, onehot.float()).to(x.dtype)
    h = torch.einsum("...d,dr->...r", x.float(), a)
    return scale * torch.einsum("...r,rf->...f", h, b).to(x.dtype)


def _attention(layers: dict, cfg: TextConfig, layer: int, x: torch.Tensor, cos, sin,
               cache: Optional[KVCache], cache_pos, use_flash: bool,
               lengths: Optional[torch.Tensor], rows: Optional[torch.Tensor],
               paged: Optional[tuple] = None, lora: Optional[dict] = None,
               lora_scale: float = 0.0, lora_onehot: Optional[torch.Tensor] = None,
               mesh=None, block: Optional[_Block] = None, cache_mask=None,
               dest: Optional[tuple] = None, attn_mask: Optional[torch.Tensor] = None):
    B, S, _ = x.shape
    qkv = _project(x.reshape(B * S, -1), layers["wqkv"], layer).reshape(B, S, -1)
    if lora and "wqkv" in lora:
        qkv = qkv + _lora_delta(x, lora["wqkv"], layer, lora_scale, lora_onehot)
    q_size = cfg.q_size
    if dest is not None:
        # the fused prologue, one kernel: RoPE, the cache's quantization and
        # write at ``dest``, the rotated query (and the fresh k, v for flash)
        q, k, v = rope_kv_write(qkv, cos, sin, cache, layer, *dest, cfg.num_heads, x.dtype,
                                fresh=use_flash, null_page=paged is not None)
    else:
        qkv = qkv.to(x.dtype)
        kv_size = cfg.num_kv_heads * cfg.head_dim
        q = qkv[..., :q_size].reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = qkv[..., q_size:q_size + kv_size].reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = qkv[..., q_size + kv_size:].reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if paged is not None:
            paged_write(cache, layer, paged[1], paged[2],
                        *quantize_kv(cache, k.transpose(1, 2), v.transpose(1, 2)))
        elif cache is not None:
            _write_cache(cache, layer, cache_pos, k, v, rows, block)
    if paged is not None:
        out = _paged_attention(cache, layer, q, lengths, paged[0], paged[3])
    elif attn_mask is not None:
        # the caller's mask in place of the causal one (moe_lm.py:644):
        # plain attention, differentiated by autograd
        out = sdpa(q, k, v, attn_mask)
    elif use_flash:
        # from-zero prefill: causal attention over the fresh k/v equals
        # attending the cache prefix, so the cache is written but not read
        out = flash_causal(q, k, v.contiguous())
    elif cache is not None and S == 1 and mesh is not None:
        # serving-mesh decode (moe_lm.py:584-599): this rank's heads and
        # block of positions, partials merged over `context`
        out = mesh_decode_attention(q[:, 0], cache, layer, lengths, mesh)[:, None].to(q.dtype)
    elif cache is not None and S == 1:
        out = decode_attention(q[:, 0], cache.k, cache.v, layer, lengths,
                               cache.k_scale, cache.v_scale)[:, None]
    elif cache is not None and cache_mask is not None and mesh is not None:
        # cached prefill under context parallelism (moe_lm.py:600-609): the
        # query chunk against this rank's block of the just-written cache
        out = cp_cached_prefill_attention(q, cache, layer, cache_mask, mesh)
    elif cache is not None and cache_mask is not None:
        # several tokens a lane not from zero (the verify step): plain torch
        # with the decode kernel's roundings, as the JAX package's XLA branch
        out = cached_attention_plain(q, cache.k, cache.v, layer, cache_mask, cache.k_scale,
                                     cache.v_scale)
    else:
        raise NotImplementedError(
            "attention over a cache for more than one new token on a serving mesh without a "
            "context axis is not ported (ROADMAP queue 1 item 11)")
    out = out.reshape(B, S, q_size)
    proj = _project(out.reshape(B * S, q_size), layers["wo"], layer).reshape(B, S, -1)
    if lora and "wo" in lora:
        proj = proj + _lora_delta(out, lora["wo"], layer, lora_scale, lora_onehot)
    return proj.to(x.dtype)


def _shared_slots(cfg: TextConfig, T: int, dtype, device):
    """The fused shared experts as always-on slots: ids E..E+ns-1 with
    combine weight 1 for every token (moe_lm.py:911-927)."""
    ns = cfg.num_shared_experts
    ids = torch.arange(cfg.num_experts, cfg.num_experts + ns, dtype=torch.int32, device=device)
    return ids.expand(T, ns), torch.ones((T, ns), dtype=dtype, device=device)


def decode_kernel_tile(I: int) -> Optional[int]:
    """The intermediate tile ``ft`` the JAX package gives moe_decode_int4
    (moe_lm.py:945-961): all of I when I is a multiple of 128 up to 2048,
    else the largest of 1024, 512, 256, 128 that divides I, else none (and
    the reference's dequantizing path serves, at any T). W4A8 re-quantizes
    h per row of one tile; the port quantizes over all of I, so it matches
    the reference where ft == I."""
    cands = (I,) if I % 128 == 0 and I <= 2048 else (1024, 512, 256, 128)
    return next((f for f in cands if I % f == 0), None)


def prefill_kernel_tile(I: int) -> Optional[int]:
    """The intermediate tile the JAX package gives moe_prefill_int4
    (moe_lm.py:985-1002): the first of 512, 256, 128 that divides I, else
    none (and the JAX package dequantizes in XLA instead, as the port does:
    then ``decode_kernel_tile`` is none too). 128 at I = 1664."""
    return next((f for f in (512, 256, 128) if I % f == 0), None)


def lora_block_size(E: int) -> int:
    """Experts per block of the blocked expert-LoRA path (moe_lm.py:733-736):
    ``LORA_EBLOCK`` where it divides E, else the largest divisor of E that
    is at most 16 (11 at 64 + 2 fused experts, in 6 blocks)."""
    eb = LORA_EBLOCK
    if eb <= 0 or E % eb:
        eb = next((b for b in range(min(16, E), 0, -1) if E % b == 0), E)
    return eb


def _frozen_base(fn, *args):
    """``fn(*args)`` over a quantized base's experts, dequantized inside
    ``fn``. Where autograd records, under a non-reentrant checkpoint: the
    backward runs ``fn`` again (the dequantize included) instead of saving
    the float weights, which at flagship would keep 28 layers x 4 blocks x
    408 MB of bf16 copies of the frozen int8 experts alive until the
    backward reaches them."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _experts_lora_blocked(x: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
                          w1q: dict, w2q: dict, lora: dict, lora_scale: float,
                          lora_onehot: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Expert LoRA over a quantized layer (int4 or int8 stacks [E, ...]), one
    block of experts at a time (moe_lm.py:682-760): the adapters sit inside
    the expert GLU, so the int4 kernels cannot run beneath them; the block's
    float weights come from ``expert_block_dequant`` and go through the
    capacity path with the adapters' factors of the block (sliced on axis
    ndim - 3, which is E for single [E, ...] and stacked [A, E, ...]
    factors). Slots outside the block take weight 0 and the id ``eb``,
    which the dispatch sends to its trash row; the blocks' outputs are
    summed in f32. A layer of at most 16 experts is one block, run without
    the masking and the sum. In training each block runs under
    ``_frozen_base``."""
    E = (w1q["q4"] if "q4" in w1q else w1q["q"]).shape[0]
    eb = lora_block_size(E)
    lw1, lw2 = lora.get("w1"), lora.get("w2")

    def block(tree, e0):
        return None if tree is None else {f: v.narrow(v.dim() - 3, e0, eb)
                                          for f, v in tree.items()}

    def run(e0, il, wts):
        def blk(x, il, wts):
            return experts_grouped(x, il, wts, expert_block_dequant(w1q, "w1", e0, eb, dtype),
                                   expert_block_dequant(w2q, "w2", e0, eb, dtype),
                                   lora_w1=block(lw1, e0), lora_w2=block(lw2, e0),
                                   lora_scale=lora_scale, lora_onehot=lora_onehot)
        return _frozen_base(blk, x, il, wts)

    if eb == E:
        return run(0, indices, weights)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e0 in range(0, E, eb):
        il = indices - e0
        valid = (il >= 0) & (il < eb)
        acc = acc + run(e0, torch.where(valid, il, eb),
                        torch.where(valid, weights, torch.zeros_like(weights))).float()
    return acc.to(dtype)


def _moe_ffn(layers: dict, cfg: TextConfig, layer: int, x: torch.Tensor, shared,
             training: bool = False, lora: Optional[dict] = None, lora_scale: float = 0.0,
             lora_onehot: Optional[torch.Tensor] = None, mesh=None):
    """The routed experts, and the shared ones fused in as always-on slots
    (``shared``) or as their own MLP (moe_lm.py:763-1057). Returns (out [B,
    S, D], z_loss, aux_loss). ``lora_onehot`` is the token-level [A, B*S]
    adapter selector of multi-adapter serving.

    On a mesh whose ``expert`` axis is above 1 the routed experts are
    expert-parallel (``_moe_ffn_ep``, moe_lm.py:793-860).

    A serving prefill of more than MOE_CHUNK tokens (MOE_CHUNK_LONG at
    32768 and over) runs in slices of that size one after another, with
    its slice of the selector, as the JAX package's lax.map does; exact, as
    routing is per token. A token count past the slice that is not a
    multiple of it raises NotImplementedError: the JAX package runs it
    unsliced, and the port has not been run at such sizes (prompt buckets
    are powers of two, so the engine never makes one). Training is never
    sliced (moe_lm.py:871)."""
    B, S, D = x.shape
    flat = x.reshape(-1, D)
    T = flat.shape[0]
    if mesh is not None and mesh.shape["expert"] > 1:
        out, z_loss, aux_loss = _moe_ffn_ep(layers, cfg, layer, flat, training, lora,
                                            lora_scale, lora_onehot, mesh)
        return out.reshape(B, S, D), z_loss, aux_loss
    chunk = MOE_CHUNK_LONG if T >= 32768 else MOE_CHUNK
    if T > chunk and not training:
        if T % chunk:
            raise NotImplementedError(
                f"an MoE call over {T} tokens, past the {chunk}-token slice and not a "
                "multiple of it, is not ported")
        outs = [_moe_ffn_tokens(layers, cfg, layer, flat[i:i + chunk], shared, training, lora,
                                lora_scale,
                                None if lora_onehot is None else lora_onehot[:, i:i + chunk])[0]
                for i in range(0, T, chunk)]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return torch.cat(outs).reshape(B, S, D), zero, zero
    out, z_loss, aux_loss = _moe_ffn_tokens(layers, cfg, layer, flat, shared, training, lora,
                                            lora_scale, lora_onehot)
    if training and mesh is not None and mesh.batch_size > 1:
        # the router's losses over the global batch, this rank's share
        from aria_tpu_torch.parallel.ep import router_losses

        logits = router_logits(flat, layers["gate"][layer], True)
        z_loss, aux_loss = router_losses(logits, torch.topk(logits, cfg.moe_topk, dim=-1)[1],
                                         cfg.moe_z_loss_coeff, cfg.moe_aux_loss_coeff, mesh)
    return out.reshape(B, S, D), z_loss, aux_loss


def _moe_ffn_tokens(layers: dict, cfg: TextConfig, layer: int, flat: torch.Tensor, shared,
                    training: bool, lora: Optional[dict], lora_scale: float,
                    lora_onehot: Optional[torch.Tensor] = None):
    T = flat.shape[0]
    w1, w2 = layers["w1"], layers["w2"]
    routing = route_topk(flat, layers["gate"][layer], cfg.moe_topk,
                         z_loss_coeff=cfg.moe_z_loss_coeff,
                         aux_loss_coeff=cfg.moe_aux_loss_coeff, training=training)
    indices, weights = routing.indices, routing.weights
    if shared is not None:
        indices = torch.cat([indices, shared[0][:T]], dim=1)
        weights = torch.cat([weights, shared[1][:T]], dim=1)
    expert_lora = lora is not None and ("w1" in lora or "w2" in lora)
    if expert_lora:  # inside the GLU: the capacity path (moe_lm.py:1010-1033)
        lw = {n: {f: lora[n][f][layer] for f in ("a", "b")} for n in ("w1", "w2") if n in lora}
        if isinstance(w1, dict):  # quantized: one block of experts at a time
            w1l, w2l = ({k: v[layer] for k, v in w.items()} for w in (w1, w2))
            out = _experts_lora_blocked(flat, indices, weights, w1l, w2l, lw, lora_scale,
                                        lora_onehot, flat.dtype)
        else:
            out = experts_grouped(flat, indices, weights, w1[layer], w2[layer],
                                  lora_w1=lw.get("w1"), lora_w2=lw.get("w2"),
                                  lora_scale=lora_scale, lora_onehot=lora_onehot)
    elif training or decode_kernel_tile(cfg.moe_intermediate_size) is None:
        # training; and serving where the reference has no kernel tile for I
        # (not a multiple of 128: its dequantizing path, moe_lm.py:1020-1044)
        def dispatch(flat, indices, weights):
            w1l, w2l = dequantize_expert_weights(
                *({k: v[layer] for k, v in w.items()} if isinstance(w, dict) else w[layer]
                  for w in (w1, w2)), dtype=flat.dtype)
            if T <= GATHER_PATH_MAX_TOKENS:
                return experts_gather(flat, indices, weights, w1l, w2l)
            if cfg.num_experts > 2 * cfg.moe_topk:
                return experts_ragged(flat, indices, weights, w1l, w2l)
            return experts_grouped(flat, indices, weights, w1l, w2l)
        out = (_frozen_base(dispatch, flat, indices, weights) if isinstance(w1, dict)
               else dispatch(flat, indices, weights))
    elif is_quantized_int4(w1):
        experts = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], layer)
        if T <= DECODE_KERNEL_MAX_TOKENS:
            out = moe_decode_int4(flat, indices, weights, *experts, act_int8=MOE_A8)
        else:
            out = experts_segmented_int4(flat, indices, weights, *experts)
    elif T <= DECODE_KERNEL_MAX_TOKENS:
        if is_quantized(w1):
            out = moe_decode_quant(flat, indices, weights, w1["q"], w1["s8"], w2["q"], w2["s8"],
                                   layer)
        else:
            out = moe_decode(flat, indices, weights, w1, w2, layer)
    else:
        # the layer's dequantized int8 experts live for this call only
        w1l, w2l = dequantize_expert_weights(_layer_weight(w1, layer), _layer_weight(w2, layer),
                                             dtype=flat.dtype)
        if cfg.num_experts > 2 * cfg.moe_topk:
            out = experts_ragged(flat, indices, weights, w1l, w2l)
        else:
            out = experts_grouped(flat, indices, weights, w1l, w2l)
    if shared is None:
        out = out + _shared_mlp(layers, layer, flat, lora, lora_scale, lora_onehot)
    return out, routing.z_loss, routing.aux_loss


def _shared_mlp(layers: dict, layer: int, flat: torch.Tensor, lora: Optional[dict],
                lora_scale: float, lora_onehot: Optional[torch.Tensor]) -> torch.Tensor:
    """The unfused shared experts' MLP (moe_lm.py:1049-1056), in x's dtype."""
    h = linear(flat, _layer_weight(layers["shared_w1"], layer))
    if lora and "shared_w1" in lora:
        h = h + _lora_delta(flat, lora["shared_w1"], layer, lora_scale, lora_onehot)
    h = glu(h.to(flat.dtype))
    shared_out = linear(h, _layer_weight(layers["shared_w2"], layer))
    if lora and "shared_w2" in lora:
        shared_out = shared_out + _lora_delta(h, lora["shared_w2"], layer, lora_scale,
                                              lora_onehot)
    return shared_out.to(flat.dtype)


def _moe_ffn_ep(layers: dict, cfg: TextConfig, layer: int, flat: torch.Tensor,
                training: bool, lora: Optional[dict], lora_scale: float,
                lora_onehot: Optional[torch.Tensor], mesh):
    """The expert-parallel branch (moe_lm.py:793-860): the routed experts
    through ``experts_ep`` over this rank's [L, E/n, ...] stacks, the shared
    MLP beside them. Serving pads T to a multiple of n with zero rows whose
    outputs are dropped, and up to 8 x GATHER_PATH_MAX_TOKENS tokens gives
    the whole stacks and the layer to the decode-MoE kernel; above, and in
    training (where T must divide), the layer's slice goes through the
    dequantize and the ``gmm`` kernels. Where the JAX package cannot take
    this branch (expert LoRA, a fused stack, T that does not divide in
    training) it lets GSPMD gather the stacks; the port raises instead (a
    fused stack in ``lm_forward``)."""
    from aria_tpu_torch.parallel.ep import experts_ep

    n = mesh.shape["expert"]
    T, D = flat.shape
    if lora is not None and ("w1" in lora or "w2" in lora):
        raise NotImplementedError("expert LoRA over an expert mesh: the JAX package gathers "
                                  "the expert stacks there, which the port does not do")
    if training and T % n:
        raise ValueError(f"training over expert={n}: {T} tokens must divide")
    pad = (-T) % n
    ep_flat = torch.cat([flat, flat.new_zeros((pad, D))]) if pad else flat
    gate = layers["gate"][layer].float()
    common = dict(z_loss_coeff=cfg.moe_z_loss_coeff, aux_loss_coeff=cfg.moe_aux_loss_coeff)
    w1, w2 = layers["w1"], layers["w2"]
    if not training and ep_flat.shape[0] <= 8 * GATHER_PATH_MAX_TOKENS:
        out, z_loss, aux_loss = experts_ep(ep_flat, gate, cfg.moe_topk, w1, w2, mesh,
                                           training=False, layer_idx=layer, act_int8=MOE_A8,
                                           **common)
    else:
        w1l, w2l = ({k: v[layer] for k, v in w.items()} if isinstance(w, dict) else w[layer]
                    for w in (w1, w2))
        out, z_loss, aux_loss = experts_ep(ep_flat, gate, cfg.moe_topk, w1l, w2l, mesh,
                                           training=training, **common)
    out = out[:T] + _shared_mlp(layers, layer, flat, lora, lora_scale, lora_onehot)
    return out, z_loss, aux_loss


def lm_forward(
    params: dict,
    cfg: TextConfig,
    tokens: Optional[torch.Tensor] = None,  # [B, S]
    *,
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, D]
    positions: Optional[torch.Tensor] = None,  # [S] or [B, S]
    cache: Optional[KVCache] = None,
    cache_pos=None,  # write offset: an int, or an int32 [B] tensor per lane
    logit_position=None,  # logits at this position only: an int, or [B] per row
    causal_flash: Optional[bool] = None,  # caller asserts causal-from-0 attention
    page_table: Optional[torch.Tensor] = None,  # [B, MAXP] int32: ``cache`` is paged
    training: bool = False,  # router losses, the training MoE dispatch
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, S, S]; True = attend
    lora: Optional[dict] = None,  # {"layers": {name: {"a": [L, ...], "b": [L, ...]}}}
    lora_scale: float = 0.0,
    lora_onehot: Optional[torch.Tensor] = None,  # [A, B] selector over stacked [L, A, ...]
    remat: bool = False,  # recompute each layer in the backward
    mesh=None,  # parallel/mesh.Mesh: see below
    head: bool = True,  # False: the final norm's output in place of the logits
) -> LMOutput:
    """Run the decoder. Without a cache, or with ``causal_flash``, attention
    is causal over the tokens given (flash kernel); with a cache and one
    token, it attends the cache (decode-attention kernel) up to
    ``cache_pos + 1`` for each lane; without a cache and with a ``mask``,
    it attends where the mask is True (plain ``sdpa``, moe_lm.py:1107-1109);
    with a cache and several tokens not
    from zero, token i of lane b attends positions up to ``cache_pos[b] +
    i`` (``cached_attention_plain``). With a ``page_table`` the cache is a
    ``PagedKVCache`` under the same rule. The cache is updated in place and
    returned, with the router's z and aux losses summed over the layers (0 unless
    ``training``). Multi-adapter serving (``engine/multi_lora.py``) passes
    stacked factors with ``lora_scale=1.0`` and ``lora_onehot``: attention
    takes the row selector, the MoE its token-level expansion (each row's
    column repeated S times, moe_lm.py:1123-1126).

    With a ``mesh`` (``parallel/mesh.py``) every rank of it returns the
    same logits. Over ``model`` or ``context`` the parameters are
    replicated and ``cache`` is this rank's block (``KVCache.init(mesh=)``),
    sharded by head over ``model`` and by position over ``context``
    (moe_lm.py:308-317, :584-616): writes land in the block, decode goes
    through ``mesh_decode_attention``, and a prefill takes causal flash over
    the fresh k/v when ``context`` is 1, else the blockwise
    ``cp_cached_prefill_attention`` over the written cache. On a mesh with
    neither the cache is whole and attention runs as on one card, the
    fused prologue included. Over ``expert`` the expert stacks are this
    rank's [L, E/n, ...] shards (unfused shared experts) and the MoE is
    expert-parallel (``_moe_ffn_ep``). Training takes a mesh of ``data``,
    ``fsdp`` and ``expert``: ``x`` is this rank's rows, and over ``fsdp``
    the layer stacks are this rank's shards, each layer gathered whole just
    before it runs (``parallel/fsdp.py``)."""
    if inputs_embeds is None:
        x = embed_tokens(params["embed"], tokens, dtype=params["final_norm"].dtype)
    else:
        x = inputs_embeds
    B, S, _ = x.shape
    # the KV cache's mesh: heads over model, positions over context; on a mesh
    # with neither the cache is whole and attention runs as on one card
    kv_mesh = mesh if mesh is not None and (mesh.shape["model"] > 1
                                            or mesh.shape["context"] > 1) else None
    if mesh is not None and training and kv_mesh is not None:
        raise NotImplementedError(
            "training over a mesh with model or context above 1: weight tensor parallelism and "
            "Ulysses / ring attention are not ported (ROADMAP queue 1 item 11)")
    layers = params["layers"]
    w1 = layers["w1"]
    int4 = is_quantized_int4(w1)
    stack = w1["q4"] if int4 else w1["q"] if is_quantized(w1) else w1
    fused = "shared_w1" not in layers
    n_exp = mesh.shape["expert"] if mesh is not None else 1
    if fused and n_exp > 1:
        raise ValueError("a fused expert stack on an expert mesh: build the tree with the "
                         "shared experts unfused (fuse_shared=False); the JAX package gathers "
                         "the stacks there instead of running expert parallelism")
    if stack.shape[1] * n_exp != cfg.num_experts + (cfg.num_shared_experts if fused else 0):
        raise ValueError(f"expert stack of {stack.shape[1]} experts"
                         + (f" on each of expert={n_exp}" if n_exp > 1 else "")
                         + f": {cfg.num_experts} routed"
                         + (f" + {cfg.num_shared_experts} fused shared" if fused else ""))
    lora_layers = lora["layers"] if lora is not None else None
    expert_lora = lora_layers is not None and ("w1" in lora_layers or "w2" in lora_layers)
    if training and int4:
        raise NotImplementedError("training over int4 experts: QLoRA trains over the int8 "
                                  "tree of quantize_params")
    if mask is not None and (cache is not None or kv_mesh is not None):
        raise NotImplementedError("an attention mask is ported for uncached attention "
                                  "(training); the cached paths make their own")
    ft = decode_kernel_tile(cfg.moe_intermediate_size)
    if not (training or expert_lora) and ft not in (None, cfg.moe_intermediate_size):
        raise NotImplementedError(
            f"moe_intermediate_size {cfg.moe_intermediate_size}: the reference's decode "
            f"kernel takes a tile ft={ft}; only ft equal to the whole intermediate is ported")
    if cfg.num_kv_heads != cfg.num_heads:
        raise NotImplementedError("the attention kernels are MHA only")
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cos, sin = precompute_rope(positions, cfg.head_dim, cfg.rope_base)
    if causal_flash is None:
        causal_flash = cache is None and mask is None
    cp_n = kv_mesh.shape["context"] if kv_mesh is not None else 1
    if kv_mesh is not None and (page_table is not None or cache is None):
        raise NotImplementedError(
            "a serving mesh over model or context takes a contiguous cache: paged caches and "
            "uncached attention over such a mesh are not ported (ROADMAP queue 1 item 11)")
    if mesh is not None and page_table is not None:
        raise NotImplementedError("a paged cache over a mesh is not ported (ROADMAP queue 1 "
                                  "item 11)")
    if kv_mesh is not None and cfg.num_heads % kv_mesh.shape["model"]:
        raise ValueError(f"{cfg.num_heads} heads over model={kv_mesh.shape['model']}")
    # training over fsdp: the layer stacks are this rank's shards, each layer
    # gathered whole just before it runs (parallel/fsdp.py)
    fsdp_specs = None
    if training and mesh is not None and mesh.shape["fsdp"] > 1:
        from aria_tpu_torch.parallel.fsdp import specs_by_path
        from aria_tpu_torch.parallel.mesh import lm_param_specs

        fsdp_specs = specs_by_path({"lm": {"layers": layers}},
                                   {"lm": {"layers": lm_param_specs()["layers"]}})
    # under context parallelism a prefill reads the written cache blockwise
    # (moe_lm.py:600-616): flash over fresh k/v only with one position block
    use_flash = (bool(causal_flash) and (S > 1 or cache is None) and page_table is None
                 and cp_n == 1)
    if cache is not None and cache_pos is None:
        raise ValueError("a cache needs cache_pos")
    paged = None
    if page_table is not None:
        if not isinstance(cache_pos, torch.Tensor):
            cache_pos = torch.full((B,), cache_pos, dtype=torch.int32, device=x.device)
        cache_pos = cache_pos.expand(B).to(torch.int32)
        pages, slots = write_index(page_table, cache_pos, S, cache.page_size)
        mask = None
        if S > 1:  # kv_pos <= cache_pos + arange(S): [B, 1, S, MAXP * PS]
            kv_pos = torch.arange(page_table.shape[1] * cache.page_size, device=x.device)
            qi = cache_pos[:, None] + torch.arange(S, device=x.device)[None, :]
            mask = (kv_pos[None, None, :] <= qi[:, :, None])[:, None]
        paged = (page_table, pages, slots, mask)
    per_lane = isinstance(cache_pos, torch.Tensor)
    lengths = rows = None
    if per_lane:
        cache_pos = cache_pos.to(torch.int32)
        if S == 1 and paged is None:
            rows = torch.arange(B, dtype=torch.int32, device=x.device)
    if cache is not None and not use_flash:
        lengths = (cache_pos + S if per_lane else
                   torch.full((B,), cache_pos + S, dtype=torch.int32, device=x.device))
    block = _cache_block(cache, cfg, kv_mesh) if cache is not None and paged is None else None
    cache_mask = None
    if block is not None and not use_flash and S > 1 and (kv_mesh is None or cp_n > 1):
        # kv_pos <= cache_pos + i, over every position of the mesh under context
        kv_pos = torch.arange(block.max_seq, device=x.device)
        qi = (cache_pos[:, None] if per_lane else cache_pos) + torch.arange(S, device=x.device)
        cache_mask = (kv_pos <= qi[..., None]).reshape(-1, 1, S, block.max_seq)
    dest = _prologue_dest(cache, cache_pos, rows, B, S, paged, kv_mesh, x.device)
    shared = _shared_slots(cfg, B * S, x.dtype, x.device) if fused else None
    tok_onehot = None if lora_onehot is None else torch.repeat_interleave(lora_onehot, S, dim=1)

    def layer_fn(x, layer):
        lw, li, lr = layers, layer, lora_layers
        if fsdp_specs is not None:  # training: no cache, so layer 0 of the view
            from aria_tpu_torch.parallel.fsdp import gather_layer

            lw, li = gather_layer(layers, layer, mesh, fsdp_specs), 0
            lr = None if lora_layers is None else {
                n: {f: t[layer:layer + 1] for f, t in ab.items()}
                for n, ab in lora_layers.items()}
        normed = rms_norm(x, lw["attn_norm"][li], cfg.rms_norm_eps)
        x = x + _attention(lw, cfg, li, normed, cos, sin, cache, cache_pos, use_flash,
                           lengths, rows, paged, lr, lora_scale, lora_onehot, kv_mesh,
                           block, cache_mask, dest, mask)
        normed = rms_norm(x, lw["ffn_norm"][li], cfg.rms_norm_eps)
        out, z_loss, aux_loss = _moe_ffn(lw, cfg, li, normed, shared, training,
                                         lr, lora_scale, tok_onehot, mesh)
        return x + out, z_loss, aux_loss

    z_loss = aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.num_layers):
        if remat:
            x, zl, al = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x, zl, al = layer_fn(x, layer)
        z_loss, aux_loss = z_loss + zl, aux_loss + al

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if not head:  # the caller applies lm_head (a loss over token chunks)
        return LMOutput(None, cache, z_loss, aux_loss, x)
    if isinstance(logit_position, torch.Tensor):  # one position per row
        x = x[torch.arange(B, device=x.device), logit_position.long()][:, None]
    elif logit_position is not None:
        x = x[:, logit_position:logit_position + 1]
    logits = linear(x, params["lm_head"])
    return LMOutput(logits, cache, z_loss, aux_loss)
