"""Checkpoint I/O (counterpart of aria_tpu/checkpoint/io.py): the trainer's
checkpoints and the HF safetensors imports.

Trainer checkpoints: the JAX package writes orbax step directories; the
port writes its own format, ``{path}/step_{N}/state.pt`` (``torch.save`` of
the tree: nested dicts of tensors and ints) and ``{path}/config.json`` (the
model config, as ``dataclasses.asdict``).

The HF import implements the reference's rename/fuse map
(gptfast/scripts/convert_hf_checkpoint.py:90-162) into the port's param
tree, as the JAX package does (io.py:66-455):

- q/k are permuted from HF Llama's half-rotation RoPE layout to the
  interleaved-pair layout, then fused with v into one ``wqkv`` [in, out];
- expert fc1 [E, D, 2I] becomes out-major [E, 2I, D]; fc2 stays [E, I, D];
- the shared expert's gate/up fuse into ``shared_w1`` [D, 2*Is];
- every torch Linear weight is transposed to right-multiply [in, out];
- per-layer tensors are stacked on a leading L axis; the router gate is f32.

The reader is the port's own (the card's machine has no ``safetensors``
package): a shard is an 8-byte little-endian header length, a JSON header
of ``{name: {dtype, shape, data_offsets}}`` and the raw bytes, mapped
read-only. A tensor is a CPU view over the mapping; a first-axis slice
touches only its own rows' bytes. Stacks are filled on the device a layer
(or an expert slab) at a time, so the host never holds more than one.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from aria_tpu_torch.config import AriaConfig, config_from_dict
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops.quant import (
    fuse_shared_experts,
    quantize_dense_int4,
    quantize_expert_int4,
    quantize_lm_layers,
    quantize_weight,
)

# ---------------------------------------------------------------- trainer


def save_checkpoint(path: str, tree: Any, cfg: Optional[AriaConfig] = None, step: int = 0
                    ) -> None:
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, "state.pt.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(step_dir, "state.pt"))
    if cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_checkpoint(path: str, step: int = 0, device="cuda"
                    ) -> tuple[Any, Optional[AriaConfig]]:
    """(tree, config or None), the tensors on ``device``: the card unless
    the caller names another (``backend.device``: no card raises)."""
    tree = torch.load(os.path.join(os.path.abspath(path), f"step_{step}", "state.pt"),
                      map_location=backend.device(device), weights_only=True)
    cfg = None
    cfg_file = os.path.join(path, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = config_from_dict(json.load(f))
    return tree, cfg


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()
             and os.path.exists(os.path.join(path, d, "state.pt"))]
    return max(steps) if steps else None


# ---------------------------------------------------------------- reader

SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}


class _Shard:
    """One .safetensors file, mapped read-only."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header.pop("__metadata__", None)
        self._base = 8 + n
        self.entries = header

    def _view(self, name: str, lo: int, hi: Optional[int]) -> torch.Tensor:
        e = self.entries[name]
        dtype = SAFETENSORS_DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: safetensors dtype {e['dtype']} is not supported")
        shape = list(e["shape"])
        start, end = e["data_offsets"]
        row = int(np.prod(shape[1:], dtype=np.int64)) if shape else 1
        if shape:
            hi = shape[0] if hi is None else min(hi, shape[0])
            shape[0] = max(hi - lo, 0)
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        offset = self._base + start + lo * row * itemsize
        if offset + count * itemsize > self._base + end:
            raise ValueError(f"{name}: data_offsets {e['data_offsets']} shorter than its shape")
        with warnings.catch_warnings():  # the mapping is read-only, and so are the views
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(self._map, dtype=dtype, count=count, offset=offset)
        return t.reshape(shape)


class SafetensorsDir:
    """Tensor name -> shard index over a (sharded) safetensors directory,
    each shard mapped once (io.py:218-267). ``get`` returns a CPU tensor
    over the mapping; ``get_slice(name, lo, hi)`` rows [lo, hi) of the first
    axis, reading only their bytes. Usable as the ``sd`` mapping of
    :func:`import_hf_state_dict`."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files in {path}")
        self._shards: Dict[str, _Shard] = {}
        self.index: Dict[str, str] = {}
        for fname in files:
            shard = _Shard(os.path.join(self.path, fname))
            self._shards[fname] = shard
            for k in shard.entries:
                self.index[k] = fname

    def keys(self):
        return self.index.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def get(self, name: str) -> torch.Tensor:
        return self._shards[self.index[name]]._view(name, 0, None)

    __getitem__ = get

    def get_slice(self, name: str, lo: int, hi: int) -> torch.Tensor:
        """First-axis rows [lo, hi) without reading the rest of the tensor."""
        return self._shards[self.index[name]]._view(name, lo, hi)


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every *.safetensors in a directory, as CPU views."""
    st = SafetensorsDir(path)
    return {k: st.get(k) for k in st.keys()}


# ---------------------------------------------------------------- HF import

def _interleave_permute(w: torch.Tensor, n_head: int, head_dim: int) -> torch.Tensor:
    """HF half-rotation layout -> interleaved-pair layout (io.py:68-79).
    w: [n_head*head_dim, in_dim] (torch orientation)."""
    in_dim = w.shape[1]
    return (w.reshape(n_head, 2, head_dim // 2, in_dim).transpose(1, 2)
            .reshape(n_head * head_dim, in_dim))


def _owned(x, device: torch.device) -> torch.Tensor:
    """A tensor of its own on ``device`` from a numpy array or a view over a
    mapped shard (read-only memory that nothing may write through)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.clone() if device.type == "cpu" else x.to(device)


def _getter(sd, device) -> Callable[[str], torch.Tensor]:
    """name -> the tensor on ``device``, owned."""
    return lambda name: _owned(sd[name], device)


def _stack(n: int, fn: Callable[[int], torch.Tensor], dtype) -> torch.Tensor:
    """[n, ...] from fn(0..n-1), filled into one allocation (no list of
    parts beside the stack)."""
    first = fn(0)
    out = torch.empty((n,) + tuple(first.shape), dtype=dtype, device=first.device)
    out[0] = first
    for i in range(1, n):
        out[i] = fn(i)
    return out


def _import_vision(get, vc, dtype) -> dict:
    vt = "vision_tower.vision_model."

    def stack_v(suffix, fn=lambda x: x):
        return _stack(vc.num_layers, lambda i: fn(get(f"{vt}encoder.layers.{i}.{suffix}")), dtype)

    def t(w):
        return w.T

    return {
        "patch_embed_w": get(vt + "embeddings.patch_embedding.weight")
        .reshape(vc.hidden_size, -1).T.to(dtype).contiguous(),
        "patch_embed_b": get(vt + "embeddings.patch_embedding.bias").to(dtype),
        "pos_embed": get(vt + "embeddings.position_embedding.weight").to(dtype),
        "layers": {
            "ln1_w": stack_v("layer_norm1.weight"),
            "ln1_b": stack_v("layer_norm1.bias"),
            "ln2_w": stack_v("layer_norm2.weight"),
            "ln2_b": stack_v("layer_norm2.bias"),
            "wq": stack_v("self_attn.q_proj.weight", t),
            "bq": stack_v("self_attn.q_proj.bias"),
            "wk": stack_v("self_attn.k_proj.weight", t),
            "bk": stack_v("self_attn.k_proj.bias"),
            "wv": stack_v("self_attn.v_proj.weight", t),
            "bv": stack_v("self_attn.v_proj.bias"),
            "wo": stack_v("self_attn.out_proj.weight", t),
            "bo": stack_v("self_attn.out_proj.bias"),
            "fc1_w": stack_v("mlp.fc1.weight", t),
            "fc1_b": stack_v("mlp.fc1.bias"),
            "fc2_w": stack_v("mlp.fc2.weight", t),
            "fc2_b": stack_v("mlp.fc2.bias"),
        },
    }


def _import_projector(get, pc, dtype) -> dict:
    mp = "multi_modal_projector."

    def g(name, transpose=False):
        w = get(mp + name)
        return (w.T if transpose else w).to(dtype).contiguous()

    return {
        "query": g("query"),
        "ln_q_w": g("cross_attn.layer_norm.weight"),
        "ln_q_b": g("cross_attn.layer_norm.bias"),
        "ln_kv_w": g("cross_attn.ln_kv.weight"),
        "ln_kv_b": g("cross_attn.ln_kv.bias"),
        "q_proj": g("cross_attn.q_proj.weight", True),
        "k_proj": g("cross_attn.k_proj.weight", True),
        "v_proj": g("cross_attn.v_proj.weight", True),
        "attn_in_w": g("cross_attn.multihead_attn.in_proj_weight", True),
        "attn_in_b": g("cross_attn.multihead_attn.in_proj_bias"),
        "attn_out_w": g("cross_attn.multihead_attn.out_proj.weight", True),
        "attn_out_b": g("cross_attn.multihead_attn.out_proj.bias"),
        "linear_w": g("cross_attn.linear.weight", True),
        "linear_b": g("cross_attn.linear.bias"),
        "ln_ffn_w": g("ln_ffn.weight"),
        "ln_ffn_b": g("ln_ffn.bias"),
        "ffn_in": g("ffn.linear_in.weight", True),
        "ffn_out": g("ffn.linear_out.weight", True),
    }


LM_PREFIX = "language_model.model.layers.{}."


def _qkv_fuse(get, tc, i: int) -> torch.Tensor:
    p = LM_PREFIX.format(i)
    q = _interleave_permute(get(p + "self_attn.q_proj.weight"), tc.num_heads, tc.head_dim)
    k = _interleave_permute(get(p + "self_attn.k_proj.weight"), tc.num_kv_heads, tc.head_dim)
    v = get(p + "self_attn.v_proj.weight")
    return torch.cat([q, k, v], dim=0).T  # [in, out]


def _shared_w1(get, i: int) -> torch.Tensor:
    p = LM_PREFIX.format(i)
    return torch.cat([get(p + "mlp.shared_experts.gate_proj.weight"),
                      get(p + "mlp.shared_experts.up_proj.weight")], dim=0).T  # [D, 2*Is]


def _lm_layer_fns(get, tc) -> Dict[str, tuple]:
    """Each decoder leaf: (layer i -> its [..] tensor, dtype or None for the
    import's)."""
    def hf(suffix, fn=lambda x: x):
        return lambda i: fn(get(LM_PREFIX.format(i) + suffix))

    return {
        "attn_norm": (hf("input_layernorm.weight"), None),
        "ffn_norm": (hf("post_attention_layernorm.weight"), None),
        "wqkv": (lambda i: _qkv_fuse(get, tc, i), None),
        "wo": (hf("self_attn.o_proj.weight", lambda w: w.T), None),
        "gate": (hf("mlp.router.weight"), torch.float32),
        "w1": (hf("mlp.experts.fc1.weight", lambda w: w.transpose(1, 2)), None),  # [E, 2I, D]
        "w2": (hf("mlp.experts.fc2.weight"), None),  # [E, I, D] already
        "shared_w1": (lambda i: _shared_w1(get, i), None),
        "shared_w2": (hf("mlp.shared_experts.down_proj.weight", lambda w: w.T), None),
    }


def _lm_ends(get, dtype) -> dict:
    return {"embed": get("language_model.model.embed_tokens.weight").to(dtype),
            "final_norm": get("language_model.model.norm.weight").to(dtype),
            "lm_head": get("language_model.lm_head.weight").T.to(dtype).contiguous()}


def import_hf_state_dict(sd, cfg: AriaConfig, dtype=torch.bfloat16, *, device="cuda") -> dict:
    """HF Aria state dict (a mapping of name -> numpy array or tensor, or a
    :class:`SafetensorsDir`) -> the port's training tree on ``device``, the
    card unless the caller names another (io.py:161-215)."""
    device = backend.device(device)
    get = _getter(sd, device)
    tc = cfg.text
    ends = _lm_ends(get, dtype)
    layers = {k: _stack(tc.num_layers, fn, d or dtype)
              for k, (fn, d) in _lm_layer_fns(get, tc).items()}
    return {
        "vision": _import_vision(get, cfg.vision, dtype),
        "projector": _import_projector(get, cfg.projector, dtype),
        "lm": {"embed": ends["embed"], "layers": layers, "final_norm": ends["final_norm"],
               "lm_head": ends["lm_head"]},
    }


def import_hf_checkpoint(path: str, cfg: AriaConfig, dtype=torch.bfloat16, *, device="cuda"
                         ) -> dict:
    return import_hf_state_dict(SafetensorsDir(path), cfg, dtype, device=device)


def import_hf_serving(src, cfg: AriaConfig, *, form: str = "int8", dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """An HF Aria checkpoint in the bf16 or int8 serving form, imported a
    decoder layer at a time: leaf for leaf
    ``quantize_params(fuse_shared_experts(import_hf_checkpoint(...)))`` for
    ``form="int8"`` (``fuse_shared_experts(...)`` for ``"bf16"``, the
    float weights in ``dtype``), without the float tree of more than one
    layer on the device. ``src`` is a directory or a :class:`SafetensorsDir`."""
    if form not in ("bf16", "int8"):
        raise ValueError(f"form {form!r}: 'bf16' or 'int8'")
    device = backend.device(device)
    st = SafetensorsDir(src) if isinstance(src, str) else src
    get = _getter(st, device)
    tc = cfg.text
    fns = _lm_layer_fns(get, tc)
    out: Dict[str, Any] = {}

    def fill(dst: dict, key, v: torch.Tensor, layer: int):
        if key not in dst:
            dst[key] = torch.empty((tc.num_layers,) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=device)
        dst[key][layer] = v[0]

    for layer in range(tc.num_layers):
        one = {k: fn(layer).to(d or dtype)[None] for k, (fn, d) in fns.items()}
        one = fuse_shared_experts({"lm": {"layers": one}}, tc.num_shared_experts)["lm"]["layers"]
        if form == "int8":
            one = quantize_lm_layers(one)
        for k, v in one.items():
            if isinstance(v, dict):
                for leaf, t in v.items():
                    fill(out.setdefault(k, {}), leaf, t, layer)
            else:
                fill(out, k, v, layer)
        del one
    ends = _lm_ends(get, dtype)
    if form == "int8":
        ends["lm_head"] = quantize_weight(ends["lm_head"], input_axis=-2)
    return {
        "vision": _import_vision(get, cfg.vision, dtype),
        "projector": _import_projector(get, cfg.projector, dtype),
        "lm": {"embed": ends["embed"], "layers": out, "final_norm": ends["final_norm"],
               "lm_head": ends["lm_head"]},
    }


# ------------------------------------------------- streamed int4 serving import

def get_expert_slice(st: SafetensorsDir, name: str, e0: int, e1: int, device="cpu"
                     ) -> torch.Tensor:
    """[e0:e1] experts of an HF fc1 tensor on ``device``, transposed to
    out-major [n, 2I, D] there (the copy is of the contiguous slice)."""
    return _owned(st.get_slice(name, e0, e1), backend.device(device)).transpose(1, 2)


def shared_virtual_experts_np(get, layer_prefix: str, I: int, ns: int):
    """One layer's shared-expert GLU as ``ns`` expert-shaped virtual experts
    (``fuse_shared_experts``' semantics, io.py:433-450): gate/up rows
    j*I:(j+1)*I become virtual expert j's [2I, D] out-major w1, the matching
    down-proj columns its [I, D] w2. Keeps the reference's name; returns
    tensors."""
    gate_w = get(layer_prefix + "mlp.shared_experts.gate_proj.weight")  # [Is, D]
    up_w = get(layer_prefix + "mlp.shared_experts.up_proj.weight")
    down_w = get(layer_prefix + "mlp.shared_experts.down_proj.weight")  # [D, Is]
    v_w1 = torch.stack([torch.cat([gate_w[j * I:(j + 1) * I], up_w[j * I:(j + 1) * I]])
                        for j in range(ns)])  # [ns, 2I, D]
    v_w2 = down_w.T.contiguous().reshape(ns, I, down_w.shape[0])
    return v_w1, v_w2


def stack_small_fn(fn, L: int, dtype) -> torch.Tensor:
    return _stack(L, lambda i: fn(i).to(dtype), dtype)


def import_hf_lm_serving_int4(
    src,
    tc,
    *,
    fuse_shared: bool = True,
    expert_chunk: Optional[int] = None,
    layer_chunk: int = 4,
    dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Stream an HF Aria checkpoint's decoder straight into the int4 serving
    form on ``device`` (the card unless the caller names another),
    io.py:278-430: leaf for leaf
    ``quantize_lm_params_int4(fuse_shared_experts(import_hf_state_dict(...)))``
    (without the fuse when ``fuse_shared`` is False).

    The bf16 expert stacks never exist whole, on the host or the device:
    experts are read ``expert_chunk`` at a time as first-axis slices of
    the mapped shards, copied to the device, quantized by the port's
    ``quantize_expert_int4`` and written into packed buffers allocated at
    the first slab; wqkv / wo are quantized ``layer_chunk`` layers at a
    time. Peak device memory is the packed tree plus one slab's f32
    temporaries; the host holds no copy (the mapping's pages are the page
    cache's). ``src`` is a directory or a :class:`SafetensorsDir`."""
    device = backend.device(device)
    st = SafetensorsDir(src) if isinstance(src, str) else src
    get = _getter(st, device)
    L, E = tc.num_layers, tc.num_experts
    I, ns = tc.moe_intermediate_size, tc.num_shared_experts
    E_t = E + (ns if fuse_shared else 0)
    if expert_chunk is None:
        # the largest divisor of E up to 11: bounds the f32 temporaries
        expert_chunk = next(d for d in range(min(11, E), 0, -1) if E % d == 0)
    if E % expert_chunk:
        raise ValueError(f"expert_chunk {expert_chunk} does not divide {E} experts")

    # the expert stacks first: the multi-GB packed buffers before anything
    # transient fragments the device's memory
    bufs: Dict[str, Dict[str, torch.Tensor]] = {}

    def fill(layer, e0, w1c, w2c):
        q1, q2 = quantize_expert_int4(w1c.to(dtype), w2c.to(dtype))
        for name, qd in (("w1", q1), ("w2", q2)):
            dst = bufs.setdefault(name, {})
            for leaf, v in qd.items():
                if leaf not in dst:
                    dst[leaf] = torch.empty((L, E_t) + tuple(v.shape[1:]), dtype=v.dtype,
                                            device=device)
                dst[leaf][layer, e0:e0 + v.shape[0]] = v

    for layer in range(L):
        p = LM_PREFIX.format(layer)
        for e0 in range(0, E, expert_chunk):
            # HF fc1 is [n, D, 2I]; the kernels read out-major [n, 2I, D]
            w1c = get_expert_slice(st, p + "mlp.experts.fc1.weight", e0, e0 + expert_chunk, device)
            w2c = st.get_slice(p + "mlp.experts.fc2.weight", e0, e0 + expert_chunk)
            fill(layer, e0, w1c, _owned(w2c, device))
        if fuse_shared:
            fill(layer, E, *shared_virtual_experts_np(get, p, I, ns))

    def stream_dense(layer_fn):
        out: Dict[str, torch.Tensor] = {}
        for l0 in range(0, L, layer_chunk):
            n = min(layer_chunk, L - l0)
            q = quantize_dense_int4(_stack(n, lambda i: layer_fn(l0 + i).to(dtype), dtype))
            for k, v in q.items():
                if k not in out:
                    out[k] = torch.empty((L,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
                out[k][l0:l0 + n] = v
        return out

    fns = _lm_layer_fns(get, tc)
    layers = {
        "attn_norm": stack_small_fn(fns["attn_norm"][0], L, dtype),
        "ffn_norm": stack_small_fn(fns["ffn_norm"][0], L, dtype),
        "wqkv": stream_dense(fns["wqkv"][0]),
        "wo": stream_dense(fns["wo"][0]),
        "gate": stack_small_fn(fns["gate"][0], L, torch.float32),
        "w1": bufs["w1"],
        "w2": bufs["w2"],
    }
    if not fuse_shared:
        for key in ("shared_w1", "shared_w2"):
            layers[key] = quantize_weight(stack_small_fn(fns[key][0], L, dtype), input_axis=-2)
    ends = _lm_ends(get, dtype)
    return {
        "embed": quantize_weight(ends["embed"], input_axis=-2),
        "layers": layers,
        "final_norm": ends["final_norm"],
        "lm_head": quantize_weight(ends["lm_head"], input_axis=-2),
    }
