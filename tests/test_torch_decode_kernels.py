"""The port's serving kernels against the reference's Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions against the Pallas kernels in interpret
mode and against the reference's pure-jnp oracles, on the same inputs
made with numpy:

* ``paged_decode_plain`` vs ``ops.paged_decode`` and
  ``ref.paged_decode_ref`` on the shapes of
  ``tests/test_kernels.py::TestPagedDecodeKernel`` plus G = 3
  (llama3.2-3b's 24 query / 8 kv heads, hd 128), float32 within 2e-5
  and bfloat16 within 2e-2, the tolerances of that test;
* the CUDA kernel's split and merge, in plain PyTorch
  (``paged_decode_partials_plain`` + ``merge_partials_plain``), against
  the same two, for 1, 2, an odd count not dividing the pages, and one
  split a page, at lengths 0, 1, not a page multiple and full; and
  ``split_plan``, a function of shapes alone;
* ``hash_lookup_plain`` vs ``ops.prefetch_lookup`` and
  ``ref.hash_lookup_ref``, exactly, on the shapes of
  ``TestHashLookupKernel``, with Q = 1 and EMPTY (-1) queries, and
  against the port's ``core.mithril.lookup`` on a mined state.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashindex import bucket_of
from repro.kernels import ops as ref_ops
from repro.kernels import ref

from repro_torch.core import MithrilConfig, init_state, lookup, record
from repro_torch.kernels import ops
from repro_torch.kernels.hash_lookup import (hash_lookup_kernel,
                                             hash_lookup_plain)
from repro_torch.kernels.paged_decode import (MAX_PAGES_PER_SPLIT,
                                              merge_partials_plain,
                                              paged_decode_kernel,
                                              paged_decode_partials_plain,
                                              paged_decode_plain, split_plan)

# (b, hq, hkv, hd, ps, npg): TestPagedDecodeKernel's four shapes, then G = 3
DECODE_SHAPES = [(2, 8, 2, 32, 16, 4), (1, 4, 4, 64, 32, 8),
                 (3, 16, 8, 64, 8, 6), (2, 4, 1, 128, 64, 2),
                 (2, 24, 8, 128, 16, 3)]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def decode_inputs(rng, b, hq, hkv, hd, ps, npg, zero_row=False):
    n_total = npg * b + 2
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_total, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_total, ps, hkv, hd)).astype(np.float32)
    tab = rng.choice(n_total, (b, npg), replace=False).astype(np.int32)
    lengths = rng.integers(1, npg * ps + 1, b).astype(np.int32)
    if zero_row:                  # every position of row 0 masked
        lengths[0] = 0
    return q, kp, vp, tab, lengths


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,hd,ps,npg", DECODE_SHAPES)
def test_paged_decode_plain_matches_pallas_and_oracle(rng, b, hq, hkv, hd,
                                                      ps, npg, dtype):
    t_dtype, j_dtype, tol = DTYPES[dtype]
    q, kp, vp, tab, lengths = decode_inputs(rng, b, hq, hkv, hd, ps, npg)
    got = paged_decode_plain(*(torch.tensor(x).to(t_dtype)
                               for x in (q, kp, vp)),
                             torch.tensor(tab), torch.tensor(lengths))
    assert got.dtype == t_dtype and got.shape == (b, hq, hd)
    j_args = [jnp.asarray(x, j_dtype) for x in (q, kp, vp)] + [
        jnp.asarray(tab), jnp.asarray(lengths)]
    for want in (ref_ops.paged_decode(*j_args),
                 ref.paged_decode_ref(*j_args)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_paged_decode_fully_masked_row_averages_v(rng):
    """The finite mask value: a row whose every position is masked gets
    the uniform average of V over its pages, as the reference does."""
    q, kp, vp, tab, lengths = decode_inputs(rng, 2, 8, 2, 32, 16, 4,
                                            zero_row=True)
    got = paged_decode_plain(*(torch.tensor(x) for x in
                               (q, kp, vp, tab, lengths)))
    assert torch.isfinite(got).all()
    want = ref_ops.paged_decode(*(jnp.asarray(x) for x in
                                  (q, kp, vp, tab, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    mean_v = vp[tab[0]].reshape(-1, 2, 32).mean(0)           # (Hkv, hd)
    np.testing.assert_allclose(got[0].numpy(),
                               np.repeat(mean_v, 4, axis=0), rtol=2e-5,
                               atol=2e-5)


def test_paged_decode_wrapper_takes_int64_tables_on_the_cpu(rng):
    q, kp, vp, tab, lengths = decode_inputs(rng, 3, 6, 2, 16, 8, 5)
    ops.reset_launch_counts()
    args = [torch.tensor(x) for x in (q, kp, vp)]
    got = ops.paged_decode(*args, torch.tensor(tab.astype(np.int64)),
                           torch.tensor(lengths.astype(np.int64)))
    want = paged_decode_plain(*args, torch.tensor(tab),
                              torch.tensor(lengths))
    assert torch.equal(got, want)
    assert ops.launch_counts()["paged_decode"] == 0


# DECODE_SHAPES plus two whose pages split into an odd count that does
# not divide them (7 pages in 3 splits, 11 in 3)
SPLIT_SHAPES = DECODE_SHAPES + [(2, 8, 2, 32, 16, 7),
                                (2, 24, 8, 128, 16, 11)]
LENGTH_KINDS = ("zero", "one", "ragged", "full")


def split_sizes(npg):
    """pages_per_split giving 1 split, 2 splits, an odd count that does
    not divide npg (where one exists) and npg splits."""
    odd = [p for p in range(2, npg) if npg % p and -(-npg // p) % 2]
    return sorted({npg, -(-npg // 2), *odd[-1:], 1}, reverse=True)


def kind_lengths(kind, b, ps, npg):
    """Every row at 0 or 1, at half the context plus one (not a page
    multiple, so later splits lie wholly past it), or full."""
    n = {"zero": 0, "one": 1, "ragged": npg * ps // 2 + 1,
         "full": npg * ps}[kind]
    return np.full(b, n, np.int32)


@pytest.mark.parametrize("kind", LENGTH_KINDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,hd,ps,npg", SPLIT_SHAPES)
def test_split_partials_and_merge_match_pallas_and_oracle(b, hq, hkv, hd, ps,
                                                          npg, dtype, kind):
    t_dtype, j_dtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(hd * npg + b)
    q, kp, vp, tab, _ = decode_inputs(rng, b, hq, hkv, hd, ps, npg)
    lengths = kind_lengths(kind, b, ps, npg)
    t_args = [torch.tensor(x).to(t_dtype) for x in (q, kp, vp)] + [
        torch.tensor(tab), torch.tensor(lengths)]
    j_args = [jnp.asarray(x, j_dtype) for x in (q, kp, vp)] + [
        jnp.asarray(tab), jnp.asarray(lengths)]
    wants = [np.asarray(w, np.float32) for w in (
        ref_ops.paged_decode(*j_args), ref.paged_decode_ref(*j_args))]
    sizes = split_sizes(npg)
    assert sizes[0] == npg and sizes[-1] == 1
    for pps in sizes:
        n_splits = -(-npg // pps)
        m, l, acc = paged_decode_partials_plain(*t_args, pps)
        g = hq // hkv
        assert m.shape == l.shape == (b, hkv, n_splits, g)
        assert acc.shape == (b, hkv, n_splits, g, hd)
        # a split wholly past a length >= 1 is the empty partial
        past = np.arange(n_splits) * pps * ps >= lengths[:, None]
        past &= lengths[:, None] >= 1                       # (B, S)
        by_split = [x.numpy().swapaxes(1, 2) for x in (m, l, acc)]
        assert (by_split[0][past] == np.float32(-1e30)).all()
        assert (by_split[1][past] == 0).all()
        assert (by_split[2][past] == 0).all()
        assert (by_split[1][~past] > 0).all()
        got = merge_partials_plain(m, l, acc, t_dtype)
        assert got.dtype == t_dtype and got.shape == (b, hq, hd)
        for want in wants:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol, err_msg=f"pps={pps}")


def test_split_merge_of_a_fully_masked_row_averages_every_page():
    """length <= 0 reads every page on purpose: each split's partial is
    the sum of V over its pages (m = -1e30, l = its positions), and the
    merge gives the uniform average over all pages, padding included."""
    rng = np.random.default_rng(7)
    q, kp, vp, tab, _ = decode_inputs(rng, 2, 8, 2, 32, 16, 4)
    lengths = np.array([0, -3], np.int32)
    args = [torch.tensor(x) for x in (q, kp, vp, tab, lengths)]
    m, l, acc = paged_decode_partials_plain(*args, 1)
    assert (m == -1e30).all() and (l == 16).all()
    got = merge_partials_plain(m, l, acc, torch.float32)
    for row in range(2):
        mean_v = vp[tab[row]].reshape(-1, 2, 32).mean(0)
        np.testing.assert_allclose(got[row].numpy(),
                                   np.repeat(mean_v, 4, axis=0), rtol=2e-5,
                                   atol=2e-5)


def test_merge_gives_an_empty_split_weight_zero():
    """An empty partial (m = -1e30, l = 0, acc = 0) beside live ones
    leaves the merge as it is without it, whatever its position."""
    gen = torch.Generator().manual_seed(3)
    m = torch.randn((1, 2, 3, 4), generator=gen)
    l = torch.rand((1, 2, 3, 4), generator=gen) + 0.5
    acc = torch.randn((1, 2, 3, 4, 8), generator=gen)
    want = merge_partials_plain(m, l, acc, torch.float32)
    for at in range(4):
        def ins(x, v):
            return torch.cat([x[:, :, :at], v, x[:, :, at:]], 2)
        got = merge_partials_plain(
            ins(m, torch.full((1, 2, 1, 4), -1e30)),
            ins(l, torch.zeros((1, 2, 1, 4))),
            ins(acc, torch.zeros((1, 2, 1, 4, 8))), torch.float32)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_split_plan_is_a_function_of_shapes_alone():
    # llama3.2-3b's widths on 132 SMs: the full-width batch and one row
    assert split_plan(5, 8, 128, 16, 132) == (10, 13)
    assert split_plan(1, 8, 128, 16, 132) == (4, 32)
    # the quick serving shape fits one split: no merge launch
    assert split_plan(3, 2, 4, 8, 132) == (4, 1)
    for b, hkv, npg, ps, n_sm in [(1, 1, 1, 1, 1), (7, 3, 100_000, 8, 132),
                                  (64, 8, 3, 16, 132), (2, 4, 9, 64, 16)]:
        pps, n_splits = split_plan(b, hkv, npg, ps, n_sm)
        assert 1 <= pps <= min(npg, MAX_PAGES_PER_SPLIT)
        assert n_splits == -(-npg // pps) and (n_splits - 1) * pps < npg
    with pytest.raises(TypeError):
        split_plan(torch.tensor(5), 8, 128, 16, 132)
    with pytest.raises(TypeError):
        split_plan(5, 8, 128, 16, torch.tensor([132]))
    with pytest.raises(TypeError):
        split_plan(5, 8, np.int32(128), 16, 132)


def test_paged_decode_wrapper_rejects_unaligned_rows():
    """The kernel copies pool rows 16 bytes at a time (meta device: the
    checks run before any launch)."""
    meta = dict(device="meta")
    tab = torch.zeros((2, 3), dtype=torch.int32, **meta)
    lens = torch.zeros((2,), dtype=torch.int32, **meta)
    for hd, dtype in [(30, torch.float32), (36, torch.bfloat16)]:
        q = torch.zeros((2, 4, hd), dtype=dtype, **meta)
        pool = torch.zeros((6, 4, 2, hd), dtype=dtype, **meta)
        with pytest.raises(ValueError, match="16 bytes"):
            paged_decode_kernel(q, pool, pool, tab, lens)


def lookup_tables(rng, nb, w, p):
    """The table of TestHashLookupKernel: distinct keys placed in their
    bucket's first empty way, values key+1 .. key+P."""
    pf_key = np.full((nb, w), -1, np.int32)
    pf_vals = np.full((nb, w, p), -1, np.int32)
    keys = rng.choice(100000, nb, replace=False).astype(np.int32)
    for k in keys:
        b = int(bucket_of(jnp.int32(int(k)), nb))
        ways = pf_key[b]
        if (ways == -1).any():
            slot = int(np.argmax(ways == -1))
            pf_key[b, slot] = k
            pf_vals[b, slot] = np.arange(p) + k + 1
    return pf_key, pf_vals, keys


@pytest.mark.parametrize("nb,w,p,nq", [(64, 4, 2, 64), (256, 4, 3, 100),
                                       (32, 2, 2, 7), (64, 4, 2, 1)])
def test_hash_lookup_plain_matches_pallas_and_oracle(rng, nb, w, p, nq):
    pf_key, pf_vals, keys = lookup_tables(rng, nb, w, p)
    # empty ways hold values other than EMPTY, so an EMPTY query's
    # result shows which way it matched
    pf_vals[pf_key == -1] = rng.integers(500, 600, (int((pf_key == -1)
                                                        .sum()), p))
    qs = np.concatenate([keys[: nq // 2],
                         rng.integers(2 * 10**5, 3 * 10**5, nq - nq // 2)
                         ]).astype(np.int32)
    qs[rng.random(nq) < 0.2] = -1
    got = hash_lookup_plain(*(torch.tensor(x) for x in (qs, pf_key,
                                                        pf_vals)))
    assert got.dtype == torch.int32 and got.shape == (nq, p)
    j_args = [jnp.asarray(x) for x in (qs, pf_key, pf_vals)]
    for want in (ref_ops.prefetch_lookup(*j_args),
                 ref.hash_lookup_ref(*j_args)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_lookup_plain_equals_mithril_lookup():
    """The serving tier's probe (the lookup kernel's plain version on
    lane 0's tables) is ``core.mithril.lookup`` on a mined state."""
    cfg = MithrilConfig(min_support=2, max_support=8, lookahead=20,
                        rec_buckets=64, rec_ways=4, mine_rows=8,
                        pf_buckets=32, pf_ways=2, prefetch_list=3)
    st = init_state(cfg, "cpu")
    rng = np.random.default_rng(5)
    for blk in rng.integers(0, 40, 600):
        record(cfg, st, torch.tensor([blk], dtype=torch.int32))
    assert int(st.n_mines[0]) > 0 and int(st.n_pairs[0]) > 0
    queries = torch.arange(-1, 45, dtype=torch.int32)
    got = hash_lookup_plain(queries, st.pf_key[0], st.pf_vals[0])
    for i, blk in enumerate(queries.tolist()):
        want = lookup(cfg, st, torch.tensor([blk], dtype=torch.int32))[0]
        assert torch.equal(got[i], want), blk
    assert (got >= 0).any()


def test_lookup_wrapper_takes_plain_on_the_cpu_for_any_q(rng):
    pf_key, pf_vals, keys = lookup_tables(rng, 64, 4, 2)
    ops.reset_launch_counts()
    for nq in (1, 3, 255, 257):
        qs = torch.tensor(np.resize(keys, nq).astype(np.int64))
        got = ops.prefetch_lookup(qs, torch.tensor(pf_key),
                                  torch.tensor(pf_vals))
        want = ref_ops.prefetch_lookup(jnp.asarray(qs.numpy(), jnp.int32),
                                       jnp.asarray(pf_key),
                                       jnp.asarray(pf_vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.launch_counts()["hash_lookup"] == 0


def test_serving_wrappers_reject_bad_inputs():
    """Checks run before any launch (exercised through the meta device)."""
    meta = dict(device="meta")
    q = torch.zeros((2, 8, 32), **meta)
    pool = torch.zeros((6, 4, 2, 32), **meta)
    tab = torch.zeros((2, 3), dtype=torch.int32, **meta)
    lens = torch.zeros((2,), dtype=torch.int32, **meta)
    with pytest.raises(TypeError):
        paged_decode_kernel(q.half(), pool, pool, tab, lens)
    with pytest.raises(ValueError):           # Hq not a multiple of Hkv
        paged_decode_kernel(torch.zeros((2, 7, 32), **meta), pool, pool,
                            tab, lens)
    with pytest.raises(TypeError):
        paged_decode_kernel(q, pool, pool, tab.long(), lens)
    with pytest.raises(ValueError):
        paged_decode_kernel(q, pool, pool[:5], tab, lens)
    keys = torch.zeros((16, 4), dtype=torch.int32, **meta)
    vals = torch.zeros((16, 4, 2), dtype=torch.int32, **meta)
    qs = torch.zeros((5,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError):           # buckets not a power of two
        hash_lookup_kernel(qs, keys[:12], vals[:12])
    with pytest.raises(TypeError):
        hash_lookup_kernel(qs.long(), keys, vals)
