"""The port's Matérn-5/2 dispatchers on the CPU (their plain versions)
against the JAX package's oracles (``matern52_gram_ref``,
``matern52_cross_ref``) and Pallas ops (interpret mode), in float32 at 2e-5:
the reference's own tolerance (``tests/test_kernels.py``).

The cross rows of a pending set (``matern52_rows``, one launch on the card)
and the factorize operand (``matern52_operand``) are also held bit for bit
against the routes they replace: one cross row per append through the
torch-packed parameters, and the torch composition around the gram.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import gp as JG
from repro.core.gp import params as JP
from repro.kernels.matern52.ops import matern52_cross as j_cross
from repro.kernels.matern52.ops import matern52_gram as j_gram
from repro.kernels.matern52.ref import matern52_cross_ref, matern52_gram_ref
from repro_torch import convert
from repro_torch.core.gp import gp as TG
from repro_torch.core.gp.kernels import gram, gram_rows
from repro_torch.core.gp.params import GPHyperParams
from repro_torch.core.history import bucket_size
from repro_torch.kernels.matern52.kernel import (
    matern52_cross_kernel,
    matern52_operand_kernel,
)
from repro_torch.kernels.matern52.ops import (
    matern52_gram,
    matern52_operand,
    matern52_rows,
    packed_params,
    param_table,
)
from repro_torch.kernels.matern52.plain import matern52_gram_plain


def _params(d, S, seed):
    rng = np.random.default_rng(seed)
    base = np.asarray(JP.default_params(d).pack())
    packed = base + 0.3 * rng.standard_normal((S, 3 * d + 2))
    if S == 1:
        packed = packed[0]
    return packed


def _single_row(x_new, x_train, params):
    """One append's cross row as the engine computed it before the rows
    entry: torch-packed float32 parameters, float32 rows, one row a call."""
    packed, batched = packed_params(params, True, torch.float32)
    row = matern52_gram_plain(x_new[None].float(), x_train.float(), *packed)[:, 0, :]
    row = row.to(x_train.dtype)
    return row if batched else row[0]


@pytest.mark.parametrize("n,m,d", [(8, 8, 2), (37, 130, 5), (130, 64, 12)])
@pytest.mark.parametrize("warp", [True, False])
def test_gram_plain_matches_ref_and_pallas(n, m, d, warp):
    rng = np.random.default_rng(n + m)
    x1, x2 = rng.random((n, d)), rng.random((m, d))
    packed = _params(d, 1, d)
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    got = matern52_gram(torch.as_tensor(x1), torch.as_tensor(x2), tp, warp=warp)
    assert got.dtype == torch.float64 and got.shape == (n, m)
    ref = np.asarray(matern52_gram_ref(jnp.asarray(x1), jnp.asarray(x2), jp, warp=warp))
    pal = np.asarray(j_gram(jnp.asarray(x1), jnp.asarray(x2), jp, warp=warp))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pal, rtol=0, atol=2e-5)


def test_gram_and_cross_batched_over_samples():
    d, S = 4, 3
    rng = np.random.default_rng(1)
    x1 = rng.random((20, d))
    packed = _params(d, S, 2)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    got = matern52_gram(torch.as_tensor(x1), torch.as_tensor(x1), tp).numpy()
    # row 3's append onto the first 3 rows, laid on all 20 columns
    row = matern52_rows(torch.as_tensor(x1[3:4]), torch.as_tensor(x1), 3, 20, tp).numpy()
    assert got.shape == (S, 20, 20) and row.shape == (S, 1, 20)
    for s in range(S):
        jp = JP.GPHyperParams.unpack(jnp.asarray(packed[s]), d)
        ref = np.asarray(matern52_gram_ref(jnp.asarray(x1), jnp.asarray(x1), jp))
        np.testing.assert_allclose(got[s], ref, rtol=0, atol=2e-5)
        np.testing.assert_allclose(row[s, 0, :4], ref[3, :4], rtol=0, atol=2e-5)
        assert not row[s, 0, 4:].any()  # no rows there


@pytest.mark.parametrize("m,d", [(8, 2), (200, 7)])
def test_cross_plain_matches_ref_and_pallas(m, d):
    """A one-row call of the cross entry (the replay's and the interim
    picks' R = 1) on a full bucket: the row against every column."""
    rng = np.random.default_rng(m)
    xn, xt = rng.random(d), rng.random((m, d))
    packed = _params(d, 1, m)
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    xz = np.concatenate([xt, xn[None]])  # the row appended at index m
    got = matern52_rows(torch.as_tensor(xn[None]), torch.as_tensor(xz), m, m, tp)
    got = got[0].numpy()
    ref = np.asarray(matern52_cross_ref(jnp.asarray(xn), jnp.asarray(xt), jp))
    pal = np.asarray(j_cross(jnp.asarray(xn), jnp.asarray(xt), jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pal, rtol=0, atol=2e-5)


# (live rows, bucket): the jobs' buckets, one growing 8 → 16 on the way
FOLDS = [(5, 8), (7, 8), (13, 16), (29, 32), (60, 64)]


@pytest.mark.parametrize("live,bucket", FOLDS)
@pytest.mark.parametrize("warp", [True, False])
def test_rows_equal_single_row_appends(live, bucket, warp):
    """One rows call for 3 pending points equals, bit for bit, the three
    single-row calls of the sequential appends (row r against the bucket
    after rows 0…r−1, grown where it fills), on the columns each append
    reads; and each row stays within 2e-5 of the JAX Pallas row."""
    d, S, R = 6, 4, 3
    rng = np.random.default_rng(live)
    packed = _params(d, S, bucket)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    x = np.zeros((bucket, d))
    x[:live] = rng.random((live, d))
    pend = rng.random((R, d))
    size = max(bucket, bucket_size(live + R))
    rows = gram_rows(torch.as_tensor(pend), torch.as_tensor(x), live, size, tp,
                     warp=warp, backend="kernel")
    assert rows.shape == (S, R, size) and rows.dtype == torch.float64
    assert not rows[..., live + R:].any()
    xt = torch.as_tensor(x)
    for r in range(R):
        idx = live + r
        if idx >= xt.shape[0]:
            xt = torch.nn.functional.pad(xt, (0, 0, 0, bucket_size(idx + 1) - xt.shape[0]))
        if warp:
            want = _single_row(torch.as_tensor(pend[r]), xt, tp)
        else:
            p1, _ = packed_params(tp, False, torch.float32)
            want = matern52_gram_plain(torch.as_tensor(pend[r])[None].float(), xt.float(),
                                       *p1)[:, 0, :].double()
        assert torch.equal(rows[:, r, :idx], want[:, :idx])
        one = gram_rows(torch.as_tensor(pend[r])[None], xt, idx, xt.shape[0], tp,
                        warp=warp, backend="kernel")
        assert torch.equal(rows[:, r, :idx], one[:, 0, :idx])
        if warp:
            for s in range(S):
                jp = JP.GPHyperParams.unpack(jnp.asarray(packed[s]), d)
                pal = np.asarray(j_cross(jnp.asarray(pend[r]), jnp.asarray(xt.numpy()), jp))
                np.testing.assert_allclose(rows[s, r, :idx].numpy(), pal[:idx], rtol=0,
                                           atol=2e-5)
        xt = xt.clone()
        xt[idx] = torch.as_tensor(pend[r])


@pytest.mark.parametrize("live,bucket,S", [(5, 8, 1), (8, 8, 3), (29, 32, 4), (60, 64, 10)])
def test_operand_equals_composition(live, bucket, S):
    """The factorize operand in one call equals the torch composition around
    ``gram(backend="kernel")`` bit for bit, and the JAX masked kernel on its
    Pallas backend (interpret mode) within 2e-5."""
    d = 6
    rng = np.random.default_rng(bucket + S)
    x = np.zeros((bucket, d))
    x[:live] = rng.random((live, d))
    mask = np.arange(bucket) < live
    packed = _params(d, S, live)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    got = TG._masked_kernel(xt, tp, mt, "kernel")
    k = gram(xt, xt, tp, backend="kernel")
    want = TG.masked_operand(k, mt, torch.exp(2.0 * tp.log_noise) + TG._JITTER)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(matern52_operand(xt, tp, mt, TG._JITTER), want)
    draws = packed if S > 1 else packed[None]
    for s in range(S):
        jp = JP.GPHyperParams.unpack(jnp.asarray(draws[s]), d)
        ref = np.asarray(JG._masked_kernel(jnp.asarray(x), jp, jnp.asarray(mask), "pallas"))
        np.testing.assert_allclose((got if S > 1 else got[None])[s].numpy(), ref,
                                   rtol=0, atol=2e-5)


def test_param_table_is_the_engines_table():
    """Parameters unpacked from one table hand the kernels that table (no
    copy); other parameters are packed."""
    d = 3
    table = torch.as_tensor(_params(d, 5, 0))
    got, batched = param_table(GPHyperParams.unpack(table, d))
    assert batched and got.data_ptr() == table.data_ptr() and torch.equal(got, table)
    one, batched = param_table(GPHyperParams.unpack(table[2], d))
    assert not batched and one.data_ptr() == table[2].data_ptr()
    swapped = GPHyperParams.unpack(table, d)
    swapped = swapped._replace(log_warp_a=swapped.log_warp_b, log_warp_b=swapped.log_warp_a)
    got, _ = param_table(swapped)
    assert got.data_ptr() != table.data_ptr() and torch.equal(got, swapped.pack())


def test_entries_take_float64_only():
    d = 2
    table = torch.as_tensor(_params(d, 2, 0))
    x = torch.rand(8, d, dtype=torch.float64)
    with pytest.raises(TypeError):
        matern52_cross_kernel(x[:1].float(), x.float(), table.float(), 3, 8)
    with pytest.raises(ValueError):
        matern52_cross_kernel(x[:1], x, table, 9, 16)  # index past the rows
    with pytest.raises(ValueError):
        matern52_operand_kernel(x, table, torch.ones(8), 1e-8)  # mask not bool
