"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports nothing of jax, so on a GPU machine without jax it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py``. Shapes are the
flagship widths the serving path gives each kernel.
"""

import numpy as np
import pytest
import torch

from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import dense_int4 as di
from aria_tpu_torch.ops import flash as fl
from aria_tpu_torch.ops import moe_decode_kernel as mk
from aria_tpu_torch.ops.quant import quantize_dense_int4, quantize_expert_int4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def test_dense_int4_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = quantize_dense_int4(_randn(g, 2, 2560, 7680, scale=2560**-0.5))
    for T in (1, 64, 128):
        x = _randn(g, T, 2560)
        # both are f32 sums of exact products; only the order differs
        torch.testing.assert_close(di.dense_int4(x, w, 1), di.dense_int4_plain(x, w, 1),
                                   rtol=1e-4, atol=1e-4)
    assert di.dense_int4.launches >= 3


def test_moe_decode_int4_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    E, I, D, k = 10, 1664, 2560, 2
    w1, w2 = quantize_expert_int4(_randn(g, 1, E, 2 * I, D, scale=D**-0.5),
                                  _randn(g, 1, E, I, D, scale=I**-0.5))
    rng = np.random.RandomState(0)
    for T in (1, 5, 64):
        idx = np.argsort(-rng.randn(T, E - 2), axis=1)[:, :k]
        ind = np.concatenate([idx, np.broadcast_to([E - 2, E - 1], (T, 2))], 1)
        wts = np.concatenate([rng.dirichlet(np.ones(k), T), np.ones((T, 2))], 1)
        args = (_randn(g, T, D), torch.tensor(ind, dtype=torch.int32, device=cuda),
                torch.tensor(wts, dtype=torch.bfloat16, device=cuda),
                w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
        got, ref = mk.moe_decode_int4(*args), mk.moe_decode_int4_plain(*args)
        # bf16 output, plus rare one-step flips of the int8 h re-quantization
        # where the f32 sums run in another order
        err = (got.float() - ref.float()).abs().max()
        assert err <= 2e-2 * ref.float().abs().max(), (T, err)


def test_decode_attention_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, H, S, D = 2, 3, 20, 1024, 128
    k, v = _randn(g, L, B, H, S, D), _randn(g, L, B, H, S, D)
    ks = torch.clamp_min(k.float().abs().amax(-1), 1e-6) * (1.0 / 127.0)
    vs = torch.clamp_min(v.float().abs().amax(-1), 1e-6) * (1.0 / 127.0)
    kq = torch.round(k.float() / ks[..., None]).to(torch.int8)
    vq = torch.round(v.float() / vs[..., None]).to(torch.int8)
    q = _randn(g, B, H, D)
    lengths = torch.tensor([1000, 1, 333], dtype=torch.int32, device=cuda)
    for args in ((q, kq, vq, 1, lengths, ks, vs), (q, k, v, 1, lengths)):
        # bf16 output; the plain version rounds p * v_scale to bf16 first
        torch.testing.assert_close(da.decode_attention(*args).float(),
                                   da.decode_attention_plain(*args).float(),
                                   rtol=1e-2, atol=1e-2)


def test_flash_causal_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, S in ((1, 64), (1, 128), (2, 37)):
        q, k, v = (_randn(g, B, S, 20, 128) for _ in range(3))
        # bf16 output; both round p to bf16 before p.v, the plain version
        # after normalising it
        torch.testing.assert_close(fl.flash_causal(q, k, v).float(),
                                   fl.flash_causal_plain(q, k, v).float(),
                                   rtol=1e-2, atol=1e-2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = quantize_dense_int4(_randn(g, 1, 512, 256))
    with pytest.raises(TypeError):
        di.dense_int4(_randn(g, 2, 512, dtype=torch.float32), w, 0)
    with pytest.raises(IndexError):
        di.dense_int4(_randn(g, 2, 512), w, 1)
    with pytest.raises(ValueError):
        q = _randn(g, 1, 8, 2, 64)
        fl.flash_causal(q, q, q)
