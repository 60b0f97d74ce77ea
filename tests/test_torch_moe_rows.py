"""The W4A8 decode MoE over routed rows only: ``routed_rows`` (the pair lists
``csrc/moe_decode.cu`` builds on the card) against ``unique_meta`` and the
JAX ``_unique_meta``, and the routed-rows plain version against
``moe_decode_int4_plain`` bit for bit, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.ops.moe_decode_kernel import _unique_meta as j_unique_meta
from aria_tpu_torch.ops import moe_decode_kernel as mk
from aria_tpu_torch.ops.quant import quantize_expert_int4

torch.set_num_threads(1)


def _routing(rng, T, E, ns=2, k=2):
    """top-k of E - ns routed experts plus ns always-on shared experts."""
    idx = np.argsort(-rng.randn(T, E - ns), axis=1)[:, :k]
    shared = np.broadcast_to(np.arange(E - ns, E), (T, ns))
    w = np.concatenate([rng.dirichlet(np.ones(k), T), np.ones((T, ns))], axis=1)
    return np.concatenate([idx, shared], 1).astype(np.int32), w.astype(np.float32)


@pytest.mark.parametrize("T,E,k", [(1, 10, 2), (5, 10, 2), (7, 10, 3), (32, 66, 6), (3, 66, 6)])
def test_routed_rows_list_every_pair_once_in_the_combine_order(T, E, k):
    rng = np.random.RandomState(T * 100 + E)
    ind, w = _routing(rng, T, E, k=k)
    order, pos, ids, valid, first, count = mk.routed_rows(torch.from_numpy(ind), E)
    n = T * (k + 2)
    U = min(n, E)

    # the unique experts are unique_meta's and the JAX _unique_meta's
    ids_m, valid_m, _ = mk.unique_meta(torch.from_numpy(ind), torch.from_numpy(w), E)
    np.testing.assert_array_equal(ids.numpy(), ids_m.numpy())
    np.testing.assert_array_equal(valid.numpy(), valid_m.numpy())
    meta = np.asarray(j_unique_meta(jnp.asarray(ind), jnp.asarray(w), jnp.int32(0), E)[0])
    np.testing.assert_array_equal(valid.numpy(), meta[U:2 * U])
    ok = valid.numpy() == 1
    np.testing.assert_array_equal(ids.numpy()[ok], meta[:U][ok])

    # order is a permutation, pos its inverse, sorted by expert and stable
    order, pos = order.numpy(), pos.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    np.testing.assert_array_equal(order[pos], np.arange(n))
    flat = ind.reshape(-1)
    assert (np.diff(flat[order]) >= 0).all()
    same = np.diff(flat[order]) == 0
    assert (np.diff(order)[same] > 0).all()

    # each valid expert's slice holds exactly the (token, slot) pairs that
    # picked it, each once; the shared experts take every token
    seen = []
    for e, v, a, c in zip(ids.tolist(), valid.tolist(), first.tolist(), count.tolist()):
        if not v:
            assert c == 0 and e not in flat
            continue
        pairs = order[a:a + c]
        assert (flat[pairs] == e).all() and c == (flat == e).sum()
        if e >= E - 2:
            np.testing.assert_array_equal(pairs // (k + 2), np.arange(T))
        seen.extend(pairs.tolist())
    assert sorted(seen) == list(range(n))

    # the combine adds a token's pairs in unique_meta's u order
    u_of = {e: u for u, (e, v) in enumerate(zip(ids.tolist(), valid.tolist())) if v}
    for t in range(T):
        us = [u_of[e] for e in ind[t]]
        if T == 1:
            assert us == list(range(k + 2))  # slot order
        else:
            assert [ids[u].item() for u in sorted(us)] == sorted(ind[t].tolist())


@pytest.fixture(scope="module")
def experts():
    g = torch.Generator().manual_seed(3)
    L, E, I, D = 2, 10, 128, 512
    w1 = torch.randn((L, E, 2 * I, D), generator=g) * D**-0.5
    w2 = torch.randn((L, E, I, D), generator=g) * I**-0.5
    q1, q2 = quantize_expert_int4(w1, w2)
    return E, D, (q1["q4"], q1["sg"], q2["q4"], q2["s8"])


@pytest.mark.parametrize("T", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_rows_plain_is_the_plain_version_bit_for_bit(experts, T, dtype):
    E, D, stacks = experts
    rng = np.random.RandomState(T)
    ind, w = _routing(rng, T, E)
    args = (torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(dtype),
            torch.from_numpy(ind), torch.from_numpy(w).to(dtype), *stacks, 1)
    got, ref = mk.moe_decode_int4_routed_plain(*args), mk.moe_decode_int4_plain(*args)
    assert got.dtype == ref.dtype == dtype
    assert torch.equal(got, ref)


def test_routed_rows_plain_leaves_an_unpicked_expert_out(experts):
    """An expert no token picks is absent from the lists, and changing its
    weights changes nothing."""
    E, D, (w1q4, w1sg, w2q4, w2s8) = experts
    rng = np.random.RandomState(9)
    _, w = _routing(rng, 6, E)
    picks = np.stack([rng.choice([0, 1, 2, 4, 5, 6, 7], 2, replace=False) for _ in range(6)])
    ind = np.concatenate([picks, np.broadcast_to([E - 2, E - 1], (6, 2))], 1).astype(np.int32)
    order, pos, ids, valid, first, count = mk.routed_rows(torch.from_numpy(ind), E)
    assert 3 not in ids[valid == 1].tolist()
    x = torch.from_numpy(rng.randn(6, D).astype(np.float32))
    args = (x, torch.from_numpy(ind), torch.from_numpy(w))
    before = mk.moe_decode_int4_routed_plain(*args, w1q4, w1sg, w2q4, w2s8, 1)
    w1q4 = w1q4.clone()
    w1q4[1, 3] = -w1q4[1, 3]
    after = mk.moe_decode_int4_routed_plain(*args, w1q4, w1sg, w2q4, w2s8, 1)
    assert torch.equal(before, after)
    assert torch.equal(before, mk.moe_decode_int4_plain(*args, w1q4, w1sg, w2q4, w2s8, 1))
