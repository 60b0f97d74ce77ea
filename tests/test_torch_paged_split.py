"""The paged decode-attention kernel's split over positions, on the CPU.

``csrc/decode_attention.cu`` reads the paged cache with the decode kernel's
body: a grid of (heads, lanes, P) blocks, P from
``paged_split_count(B, heads, maxp, page_size, sms)``, each over one chunk
of ``paged_split_bounds(maxp, page_size, P)``, the partials merged in the
launch.

- The plan: a pure function of the shapes and the card's SM count (132 on
  an H100 SXM), never of the lengths; over 2 pages of 256, P > 1 at phase
  2's low-occupancy shape (4 lanes x 20 heads) and P = 1 at the paged
  path's 32 lanes, whose 640 blocks fill the card (the card measured one
  block a lane's head fastest there); the chunks cover [0, MAXP * PS)
  exactly, their boundaries multiples of 64, so with PS % 32 == 0 every
  32-position tile lies inside one page.
- The wrapper chooses P and launches without reading ``lengths`` (on the
  meta device here: a read raises).
- ``paged_decode_attention_split_plain``, the plain rendering of the split,
  against the JAX ``paged_decode_attention`` in interpret mode at P in {1,
  2, 3}, f32 and int8 pages, and a lane of length 0 giving 0.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.engine import paged as jpaged
from aria_tpu.ops import backend as jbackend
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops import paged_attention as tpa

H100_SMS = 132  # an H100 SXM's SMs


# ------------------------------------------------------------ the plan

def test_paged_split_count_takes_no_lengths():
    params = list(inspect.signature(tpa.paged_split_count).parameters)
    assert params == ["B", "heads", "maxp", "page_size", "sms"]


@pytest.mark.parametrize("b, want", [(4, 4), (32, 1)])
def test_paged_split_count_at_the_paged_shapes(b, want):
    """Phase 2's two paged shapes over 2 pages of 256: 4 lanes x 20 heads
    split into chunks of 128 (P = 4 > 1), and the paged path's 32 lanes x
    20 heads, 640 blocks for 132 SMs, left whole (P = 1)."""
    assert tpa.paged_split_count(b, 20, 2, 256, H100_SMS) == want


@pytest.mark.parametrize("maxp, ps", [(1, 32), (2, 256), (3, 128), (5, 96), (16, 256), (128, 256)])
@pytest.mark.parametrize("b", [1, 4, 32, 256])
def test_paged_split_bounds_cover_every_position(b, maxp, ps):
    S = maxp * ps
    P = tpa.paged_split_count(b, 20, maxp, ps, H100_SMS)
    assert 1 <= P <= -(-S // 64)
    assert P == tpa.paged_split_count(b, 20, maxp, ps, H100_SMS)
    bounds = tpa.paged_split_bounds(maxp, ps, P)
    assert len(bounds) == P and bounds[0][0] == 0 and bounds[-1][1] == S
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    assert all(a0 < a1 and a0 % 64 == 0 for a0, a1 in bounds)
    # no chunk is longer than the plan's unless the block count capped P
    if P == -(-S // tpa.PAGED_CHUNK):
        assert max(a1 - a0 for a0, a1 in bounds) <= tpa.PAGED_CHUNK
    for bad in (0, -(-S // 64) + 1):
        with pytest.raises(ValueError):
            tpa.paged_split_bounds(maxp, ps, bad)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
def test_launch_chooses_the_split_without_reading_lengths(monkeypatch, pages):
    """``_launch`` with ``lengths`` and the table on the meta device (any
    read of their values raises) and a stand-in library: the kernel is
    called once with P = paged_split_count and a workspace."""
    calls = []

    class Lib:
        def aria_paged_decode_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tpa, "library", lambda: Lib())
    monkeypatch.setattr(backend, "stream", lambda: None)
    monkeypatch.setattr(backend, "sm_count", lambda dev: H100_SMS)
    B, H, PS, maxp = 4, 20, 256, 2
    shape = (2, 3, H, PS, 128)
    if pages == "int8":
        cache = tpa.PagedKVCache(torch.zeros(shape, dtype=torch.int8),
                                 torch.zeros(shape, dtype=torch.int8),
                                 torch.ones(shape[:-1]), torch.ones(shape[:-1]))
    else:
        cache = tpa.PagedKVCache(torch.zeros(shape, dtype=torch.bfloat16),
                                 torch.zeros(shape, dtype=torch.bfloat16))
    table = torch.zeros((B, maxp), dtype=torch.int32, device="meta")
    lengths = torch.zeros((B,), dtype=torch.int32, device="meta")
    q = torch.zeros((B, H, 128), dtype=torch.bfloat16)
    tpa._launch(q, cache, 1, table, lengths, None)
    assert len(calls) == 1
    P, quantized = calls[0][17], calls[0][16]
    assert quantized == int(pages == "int8")
    assert P == tpa.paged_split_count(B, H, maxp, PS, H100_SMS) > 1
    assert calls[0][8].value is not None and calls[0][9].value is not None  # the workspace


# ------------------------------------------------------------ the split against JAX

L, B, H, D, PS, NP = 2, 3, 4, 128, 128, 9
TABLE = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)


@pytest.fixture(scope="module")
def interpret():
    old = os.environ.get("ARIA_TPU_KERNELS")
    os.environ["ARIA_TPU_KERNELS"] = "interpret"
    jbackend.kernel_backend.cache_clear()
    yield
    if old is None:
        os.environ.pop("ARIA_TPU_KERNELS", None)
    else:
        os.environ["ARIA_TPU_KERNELS"] = old
    jbackend.kernel_backend.cache_clear()


def _pool(dtype):
    """Random pages for both packages: f32, or int8 with f32 scales."""
    rng = np.random.RandomState(7)
    shape = (L, NP, H, PS, D)
    q = rng.randn(B, H, D).astype(np.float32)
    if dtype == "int8":
        arrays = [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
        arrays += [rng.uniform(0.005, 0.025, shape[:-1]).astype(np.float32) for _ in range(2)]
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    else:
        arrays = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    jcache = jpaged.PagedKVCache(*(jnp.asarray(a) for a in arrays))
    tcache = tpa.PagedKVCache(*(torch.from_numpy(a.copy()) for a in arrays))
    jq = jnp.asarray(q, jnp.bfloat16 if dtype == "int8" else jnp.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16 if dtype == "int8" else torch.float32)
    return jcache, tcache, jq, tq


@pytest.mark.parametrize("dtype,rtol,atol", [("f32", 2e-4, 2e-4), ("int8", 2e-2, 5e-3)])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_paged_split_plain_matches_jax_kernel(interpret, dtype, rtol, atol, splits):
    """The split's plain rendering against the Pallas kernel in interpret
    mode: lanes across pages, one past its table, one over one position;
    the lanes' lengths fall inside, on and across the 64-position chunk
    boundaries of each P."""
    jcache, tcache, jq, tq = _pool(dtype)
    lens = np.asarray([300, 1, 3 * PS + 40], np.int32)
    for layer in range(L):
        want = jpaged.paged_decode_attention(jq, jcache, jnp.int32(layer), jnp.asarray(TABLE),
                                             jnp.asarray(lens), interpret=True)
        got = tpa.paged_decode_attention_split_plain(tq, tcache, layer, torch.from_numpy(TABLE),
                                                     torch.from_numpy(lens), splits=splits)
        assert got.dtype == (torch.bfloat16 if dtype == "int8" else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("splits", [1, 4, 6])
def test_paged_split_plain_gives_an_empty_lane_zero(splits):
    """A lane of length 0 writes 0 (every partial empty); the others equal
    the unsplit plain version."""
    _, tcache, _, tq = _pool("int8")
    lengths = torch.tensor([0, 200, 384], dtype=torch.int32)
    table = torch.from_numpy(TABLE)
    got = tpa.paged_decode_attention_split_plain(tq, tcache, 1, table, lengths, splits=splits)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = tpa.paged_decode_attention_plain(tq, tcache, 1, table, lengths)
    torch.testing.assert_close(got[1:].float(), want[1:].float(), rtol=1e-2, atol=1e-2)
