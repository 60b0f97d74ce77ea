#!/usr/bin/env python3
"""How far context-parallel decoding moves the logits in the JAX package and
in the port, on the CPU, at the configuration of ``chip_smoke.py``'s cp
check: 2 decoder layers at full width (int4 serving form), a bf16 cache of
1,536 positions (768 a rank), a 900-token prompt and 8 greedy decode steps,
the bf16-activation MoE (``ARIA_TPU_A8=0``, the port's ``MOE_A8 = False``).

    python3 tools/cp_witness.py [--seeds 0 1 2 3]

For each seed the weights come from ``aria_tpu.models.moe_lm.
init_lm_params_serving_int4`` and are carried to the port by
``checkpoint/from_jax.py``; the prompt from ``numpy.random.RandomState``.
Two readings, each the relative L2 of the stacked [1 + steps, V] logits
(the first token's and each decode step's, the decode steps fed the one-
device run's greedy tokens), as ``chip_smoke.py`` computes it:

- ``jax``: the JAX package's engine functions over a ``context=2`` mesh of
  2 host devices (``parallel/cp_cache.py``: the blockwise cached prefill
  and the stats merge of ``mesh_decode_attention``) against one device,
  the Pallas kernels in interpret mode (``ARIA_TPU_KERNELS=interpret``);
- ``port``: the port's ``lm_forward(mesh=context 2)`` on 2 CPU ranks over
  gloo against one rank's ``lm_forward``, every kernel wrapper on its plain
  PyTorch version (which rounds p to bf16 before p.v, as the JAX kernel
  does: ``aria_tpu/ops/decode_attention.py`` ``compute_t = q.dtype``, and q
  is bf16 there).

Prints one line per seed and reading, then one JSON line {"seeds": [...],
"jax": [...], "port": [...]}. ``--tiny`` runs the same at a narrow 2-layer
configuration (tests). Memory: about 6 GiB at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = {"prompt": 900, "seq": 1536, "steps": 8}  # chip_smoke.CP_SIZES' ref_*
TINY = {"prompt": 40, "seq": 256, "steps": 4}


def _text(tiny: bool):
    """The JAX TextConfig: the flagship's at 2 layers, or a narrow one."""
    from aria_tpu.config import AriaConfig, TextConfig

    if tiny:
        return TextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                          num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                          moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
    return dataclasses.replace(AriaConfig().text, num_layers=2)


def _prompt(seed: int, vocab: int, n: int) -> list:
    import numpy as np

    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab, n)]


def jax_logits(params, text, prompt, seq, steps, mesh, feed=None):
    """The JAX engine's prefill and decode step (engine/generate.py:167-232)
    with their logits kept: ([1 + steps, V] f32 numpy, the tokens fed)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aria_tpu.engine.generate import Engine
    from aria_tpu.models.moe_lm import KVCache, lm_forward

    n = len(prompt)
    bucket = 32
    while bucket < n:
        bucket *= 2
    if mesh is not None:  # as Engine(mesh=) places the int4 serving form and the cache
        from aria_tpu.parallel.mesh import serving_param_specs, shard_tree

        params = shard_tree(params, serving_param_specs(params), mesh)
    cache = Engine._shard_cache(SimpleNamespace(mesh=mesh),
                                KVCache.init(text, 1, seq, jnp.bfloat16))
    kv_pos = jnp.arange(seq)

    @jax.jit
    def prefill(params, tokens, cache):
        mask = (kv_pos[None, :] <= jnp.arange(bucket)[:, None])[None, None]
        out = lm_forward(params, text, tokens, positions=jnp.arange(bucket), mask=mask,
                         cache=cache, cache_pos=jnp.int32(0), logit_position=n - 1,
                         causal_flash=True, mesh=mesh)
        return out.logits[0, 0].astype(jnp.float32), out.cache

    @jax.jit
    def step(params, tok, cache, pos):
        mask = (kv_pos <= pos)[None, None, None, :]
        out = lm_forward(params, text, tok.reshape(1, 1), positions=pos[None], mask=mask,
                         cache=cache, cache_pos=pos, mesh=mesh)
        return out.logits[0, -1].astype(jnp.float32), out.cache

    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = prompt
    logits, cache = prefill(params, jnp.asarray(tokens), cache)
    out, fed = [np.asarray(logits)], []
    for i in range(steps):
        tok = int(out[-1].argmax()) if feed is None else feed[i]
        fed.append(tok)
        logits, cache = step(params, jnp.int32(tok), cache, jnp.int32(n + i))
        out.append(np.asarray(logits))
    return np.stack(out), fed


def jax_reading(params, text, prompt, sizes) -> float:
    """(a): the JAX CP functions over 2 host devices against one device."""
    import numpy as np

    from aria_tpu.parallel.mesh import MeshConfig, make_mesh

    one, fed = jax_logits(params, text, prompt, sizes["seq"], sizes["steps"], None)
    mesh = make_mesh(MeshConfig(context=2))
    with mesh:
        cp, _ = jax_logits(params, text, prompt, sizes["seq"], sizes["steps"], mesh, fed)
    return float(np.linalg.norm(cp - one) / np.linalg.norm(one))


def port_rank(rank: int, weights: str, text: dict, prompt: list, sizes: dict) -> float:
    """(b), one rank: the port's CP logits against one rank's, fed the
    latter's greedy tokens (chip_smoke.py's ``_cp_logits``)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    from aria_tpu_torch.config import config_from_dict
    from aria_tpu_torch.models.moe_lm import KVCache
    from aria_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    cfg = config_from_dict({"text": text}).text
    lm = torch.load(weights, weights_only=True)
    mesh = make_mesh(MeshConfig(context=2))
    with torch.inference_mode(), chip_smoke.moe_a8_off():
        cache = KVCache.init(cfg, 1, sizes["seq"], torch.bfloat16, device="cpu")
        one, fed = chip_smoke._cp_logits(lm, cfg, prompt, cache, None, sizes["steps"])
        cache = KVCache.init(cfg, 1, sizes["seq"], torch.bfloat16, device="cpu", mesh=mesh)
        cp, _ = chip_smoke._cp_logits(lm, cfg, prompt, cache, mesh, sizes["steps"], fed)
    return chip_smoke._rel_err(cp, one)


def port_reading(params, text, prompt, sizes, tmp: str) -> float:
    import jax
    import numpy as np
    import torch

    from aria_tpu_torch.checkpoint.from_jax import from_jax
    from aria_tpu_torch.parallel.distributed import run_ranks

    path = os.path.join(tmp, "lm.pt")
    torch.save(from_jax(jax.tree.map(np.asarray, params), device="cpu"), path)
    outs = run_ranks(port_rank, 2, path, dataclasses.asdict(text), prompt, sizes,
                     backend="gloo", store_dir=tmp, timeout_s=3600)
    os.remove(path)
    if outs[0] != outs[1]:
        raise AssertionError(f"the ranks read {outs}")
    return outs[0]


def witness(seeds, tiny: bool = False, log=print) -> dict:
    """{"seeds", "jax", "port", "sizes"}: both readings for each seed. The
    JAX switches are set for the call and restored after it."""
    import jax

    from aria_tpu.ops.backend import kernel_backend

    if len(jax.devices()) < 2:
        raise RuntimeError("the JAX CP reading needs 2 host devices: set XLA_FLAGS="
                           "--xla_force_host_platform_device_count=2 before jax is imported")
    saved = {k: os.environ.get(k) for k in ("ARIA_TPU_KERNELS", "ARIA_TPU_A8")}
    os.environ.update(ARIA_TPU_KERNELS="interpret", ARIA_TPU_A8="0")
    kernel_backend.cache_clear()
    try:
        return _readings(seeds, tiny, log)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        kernel_backend.cache_clear()
        jax.clear_caches()  # the JAX package reads the switches at trace time


def _readings(seeds, tiny: bool, log) -> dict:
    import jax
    import jax.numpy as jnp

    from aria_tpu.models import moe_lm as jm

    text = _text(tiny)
    sizes = TINY if tiny else FULL
    out = {"seeds": list(seeds), "jax": [], "port": [], "sizes": sizes}
    with tempfile.TemporaryDirectory(prefix="cp_witness_") as tmp:
        for seed in seeds:
            t0 = time.perf_counter()
            params = jm.init_lm_params_serving_int4(jax.random.PRNGKey(seed), text,
                                                    dtype=jnp.bfloat16)
            prompt = _prompt(seed, text.vocab_size, sizes["prompt"])
            a = jax_reading(params, text, prompt, sizes)
            b = port_reading(params, text, prompt, sizes, tmp)
            out["jax"].append(a)
            out["port"].append(b)
            log(f"seed {seed}: CP against one device, relative L2 of {1 + sizes['steps']} "
                f"logit rows: JAX {a:.4e}, port (plain) {b:.4e} "
                f"({time.perf_counter() - t0:.0f} s)", flush=True)
            del params
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tiny", action="store_true", help="a narrow 2-layer configuration")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=2".strip()
    sys.path.insert(0, ROOT)
    print(json.dumps(witness(args.seeds, args.tiny)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
