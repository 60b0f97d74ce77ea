"""Multi-LoRA serving: several task adapters resident, one chosen per
request (counterpart of aria_tpu/engine/multi_lora.py).

The adapters stay unmerged as stacked factors. A batch row picks one of
them (or none) with a one-hot selector: every adapter's rank-r delta is
computed and the row's own is selected, so mixed batches decode together.

Leaf layout: a single adapter's factors are ``[L, ...]`` (the training
format, ``train/lora.py``); stacked factors are ``[L, A+1, ...]``, the
layer axis first as the decoder indexes it, and adapter 0 all zeros: the
base model, the default of a lane.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from aria_tpu_torch.ops import backend


def stack_adapters(adapters: Sequence[dict], scales: Optional[Sequence[float]] = None,
                   device=None) -> dict:
    """Stack single-adapter trees ({"layers": {name: {"a", "b"}}}, leaves
    ``[L, ...]``) into one tree with leaves ``[L, A+1, ...]`` (multi_lora.py:26-76).

    Ranks may differ: factors are zero-padded to the largest (a padded
    column of a meets a padded row of b). Target sets may differ: a missing
    target is zeros. Each adapter's scale (alpha / rank) is folded into its
    b, in f32, so callers pass ``lora_scale=1.0``. The stacks keep the
    caller's dtype and lie on ``device`` (the adapters' own by default)."""
    adapters = [a.get("layers", a) for a in adapters]
    if scales is None:
        scales = [1.0] * len(adapters)
    out: Dict[str, dict] = {}
    for name in sorted({n for a in adapters for n in a}):
        have = [a.get(name) for a in adapters]
        proto = next(ab for ab in have if ab is not None)
        r = max(ab["a"].shape[-1] for ab in have if ab is not None)
        dev = proto["a"].device if device is None else device
        L = proto["a"].shape[0]
        a_shape = (L, len(adapters) + 1) + tuple(proto["a"].shape[1:-1]) + (r,)
        # b is [L, r, f] or [L, E, r, f]: the rank sits before the last axis
        b_shape = ((L, len(adapters) + 1) + tuple(proto["b"].shape[1:-2])
                   + (r, proto["b"].shape[-1]))
        a_stack = torch.zeros(a_shape, dtype=proto["a"].dtype, device=dev)
        b_stack = torch.zeros(b_shape, dtype=proto["b"].dtype, device=dev)
        for i, (ab, s) in enumerate(zip(have, scales), start=1):
            if ab is None:
                continue
            ra = ab["a"].shape[-1]
            a_stack[:, i, ..., :ra] = ab["a"].to(dev)
            b_stack[:, i, ..., :ra, :] = (ab["b"].to(dev).float() * s).to(b_stack.dtype)
        out[name] = {"a": a_stack, "b": b_stack}
    return {"layers": out}


def _pad_rank(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    have = x.shape[axis]
    if have == r:
        return x
    shape = list(x.shape)
    shape[axis] = r - have
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def fuse_shared_adapters(layers: dict, num_experts: int, num_shared: int,
                         moe_inter: int) -> dict:
    """Rewrite adapter factors from the training format (per-expert
    ``w1``/``w2`` and dense ``shared_w1``/``shared_w2``) into the format of
    a base whose shared MLP is fused into the expert stacks as
    ``num_shared`` virtual experts (multi_lora.py:79-185).

    The shared GLU splits over its intermediate axis, so its delta splits
    the same way: shared_w1's b columns go to virtual expert j as its
    ``[r, 2I]`` block (gate columns j*I:(j+1)*I, then the up columns at
    Is + j*I), shared_w2's a rows as its ``[I, r]`` block, and the other
    factor is tiled unchanged. Virtual experts of an adapter without shared
    targets get zeros. Works on stacked ``[L, A, ...]`` and single ``[L,
    ...]`` trees alike; every leaf keeps the dtype of the first of w1, w2,
    shared_w1, shared_w2 present (the rewrite is exact)."""
    E, ns, I = num_experts, num_shared, moe_inter
    out = dict(layers)
    sw1 = out.pop("shared_w1", None)
    sw2 = out.pop("shared_w2", None)
    proto = next((t for t in (out.get("w1"), out.get("w2"), sw1, sw2) if t is not None), None)
    dt = proto["a"].dtype if proto is not None else torch.float32

    def combine(expert, virt, eaxis):
        """Rank-align, then concatenate expert and virtual stacks on E."""
        r = max(expert["a"].shape[-1], virt["a"].shape[-1])
        a = torch.cat([_pad_rank(expert["a"].to(dt), -1, r),
                       _pad_rank(virt["a"].to(dt), -1, r)], dim=eaxis)
        b = torch.cat([_pad_rank(expert["b"].to(dt), -2, r),
                       _pad_rank(virt["b"].to(dt), -2, r)], dim=eaxis)
        return {"a": a.contiguous(), "b": b.contiguous()}

    def tile_virt(x, nlead):
        """[lead..., ...rest] -> [lead..., ns, ...rest]."""
        x = x.unsqueeze(nlead)
        return x.expand(*x.shape[:nlead], ns, *x.shape[nlead + 1:])

    # w1: routed [lead, E, D, r1] + shared_w1 a [lead, D, rs], b [lead, rs, 2Is]
    w1 = out.get("w1")
    if w1 is not None or sw1 is not None:
        if sw1 is not None:
            sa, sb = sw1["a"], sw1["b"]
            lead = tuple(sa.shape[:-2])
            rs, Is = sa.shape[-1], sb.shape[-1] // 2
            if Is != ns * I:
                raise ValueError(f"shared width {Is} is not {ns} x {I}")
            va = tile_virt(sa, len(lead))  # [lead, ns, D, rs]
            gate = sb[..., :Is].reshape(lead + (rs, ns, I)).movedim(-2, -3)
            up = sb[..., Is:].reshape(lead + (rs, ns, I)).movedim(-2, -3)
            vb = torch.cat([gate, up], dim=-1)  # [lead, ns, rs, 2I]
        else:
            ea = w1["a"]
            lead = tuple(ea.shape[:-3])
            D, r1 = ea.shape[-2], ea.shape[-1]
            va = ea.new_zeros(lead + (ns, D, r1))
            vb = ea.new_zeros(lead + (ns, r1, 2 * I))
        if w1 is None:
            w1 = {"a": va.new_zeros(lead + (E,) + tuple(va.shape[-2:])),
                  "b": vb.new_zeros(lead + (E,) + tuple(vb.shape[-2:]))}
        out["w1"] = combine(w1, {"a": va, "b": vb}, len(lead))

    # w2: routed [lead, E, I, r2] + shared_w2 a [lead, Is, rs], b [lead, rs, D]
    w2 = out.get("w2")
    if w2 is not None or sw2 is not None:
        if sw2 is not None:
            sa, sb = sw2["a"], sw2["b"]
            lead = tuple(sa.shape[:-2])
            Is, rs = sa.shape[-2], sa.shape[-1]
            if Is != ns * I:
                raise ValueError(f"shared width {Is} is not {ns} x {I}")
            va = sa.reshape(lead + (ns, I, rs))
            vb = tile_virt(sb, len(lead))  # [lead, ns, rs, D]
        else:
            ea = w2["a"]
            lead = tuple(ea.shape[:-3])
            r2, D_out = ea.shape[-1], w2["b"].shape[-1]
            va = ea.new_zeros(lead + (ns, I, r2))
            vb = ea.new_zeros(lead + (ns, r2, D_out))
        if w2 is None:
            w2 = {"a": va.new_zeros(lead + (E,) + tuple(va.shape[-2:])),
                  "b": vb.new_zeros(lead + (E,) + tuple(vb.shape[-2:]))}
        out["w2"] = combine(w2, {"a": va, "b": vb}, len(lead))
    return out


def registry_for_params(reg: "AdapterRegistry", lm_layers: dict, tc) -> "AdapterRegistry":
    """``reg`` as it is for a base with unfused shared experts, or a shallow
    copy whose factors are fused to match a base that carries them as
    virtual experts (multi_lora.py:188-213); the engines call it at build."""
    w1 = lm_layers["w1"]
    if isinstance(w1, dict):
        e_stack = (w1["q4"] if "q4" in w1 else w1["q"]).shape[1]
    else:
        e_stack = w1.shape[1]
    if e_stack == tc.num_experts:
        return reg
    layers = reg.stacked["layers"]
    needs = ("shared_w1" in layers or "shared_w2" in layers
             or ("w1" in layers and layers["w1"]["a"].shape[2] != e_stack)
             or ("w2" in layers and layers["w2"]["a"].shape[2] != e_stack))
    if not needs:
        return reg
    new = copy.copy(reg)
    new.stacked = {"layers": fuse_shared_adapters(
        layers, tc.num_experts, tc.num_shared_experts, tc.moe_intermediate_size)}
    return new


class AdapterRegistry:
    """Name -> index map over a stacked adapter tree (index 0 = the base),
    built on the card unless ``device`` names another."""

    def __init__(self, named_adapters: Dict[str, dict],
                 scales: Optional[Dict[str, float]] = None, device="cuda"):
        self.device = backend.device(device)
        self.names = list(named_adapters)
        self.index = {n: i + 1 for i, n in enumerate(self.names)}
        self.stacked = stack_adapters(
            [named_adapters[n] for n in self.names],
            [(scales or {}).get(n, 1.0) for n in self.names], device=self.device)
        self.num_adapters = len(self.names) + 1  # with the zero adapter

    def lane_onehot(self, lane_ids) -> torch.Tensor:
        """[A, B] f32 selector from per-lane adapter indices (0 = base)."""
        ids = np.asarray(lane_ids, np.int64)
        hot = np.zeros((self.num_adapters, len(ids)), np.float32)
        hot[ids, np.arange(len(ids))] = 1.0
        return torch.from_numpy(hot).to(self.device)

    def resolve(self, name: Optional[str]) -> int:
        if not name or name in ("base", "aria-tpu"):
            return 0
        if name not in self.index:
            raise KeyError(f"unknown adapter {name!r}; have {self.names}")
        return self.index[name]
