"""The port's kernel dispatchers on the CPU (their plain versions) against
the JAX package's Pallas kernels (interpret mode) and oracles.

* ``acq_score`` (fused anchor scoring), float64: against
  ``acq_score(backend="pallas")`` and ``acq_score_ref`` at atol 1e-10 over
  buckets 8/64 × S 1/8 × d 2/12 × EI/LCB. The reference pins 1e-5 and
  measures ~1e-12; both sides here compute in float64 from the same
  factors, so 1e-10 leaves room only for summation order.
* (the Matérn-5/2 gram and cross-row dispatchers: ``test_torch_matern52.py``)
* The wrappers never fall back from a CUDA tensor: with no card they raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import gp as JG
from repro.core.gp import params as JP
from repro.kernels.acq_score.ops import acq_score as j_acq_score
from repro.kernels.acq_score.ref import acq_score_ref
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core.gp import gp as TG
from repro_torch.kernels.acq_score import kernel as acq_kernel_mod
from repro_torch.kernels.acq_score.kernel import acq_score_kernel
from repro_torch.kernels.acq_score.ops import acq_score, pack_inputs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _posterior(bucket, n_live, d, S, seed=0):
    """The same shape-bucketed posterior in both packages (warping on)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((bucket, d))
    y = np.zeros(bucket)
    x[:n_live] = rng.random((n_live, d))
    y[:n_live] = rng.standard_normal(n_live)
    mask = np.zeros(bucket, dtype=bool)
    mask[:n_live] = True
    base = np.asarray(JP.default_params(d).pack())
    packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
    jpost = JG.fit_posterior_batch(
        jnp.asarray(x), jnp.asarray(y), JP.GPHyperParams.unpack(jnp.asarray(packed), d),
        jnp.asarray(mask), with_inverse=True,
    )
    tpost = convert.posterior_from_numpy(convert.posterior_to_numpy(jpost), device="cpu")
    anchors = rng.random((200, d))
    return jpost, tpost, anchors, float(y[:n_live].min())


@pytest.mark.parametrize("bucket,n_live", [(8, 5), (64, 50)])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("d", [2, 12])
@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_acq_score_plain_matches_pallas_and_oracle(bucket, n_live, S, d, acq):
    jpost, tpost, anchors, y_best = _posterior(bucket, n_live, d, S)
    got = acq_score(tpost, torch.as_tensor(anchors), y_best, acq=acq).numpy()
    assert got.shape == (S, 200)
    want_p = np.asarray(j_acq_score(jpost, jnp.asarray(anchors), y_best, acq=acq,
                                    backend="pallas"))
    want_r = np.asarray(acq_score_ref(jpost, jnp.asarray(anchors), y_best, acq=acq))
    np.testing.assert_allclose(got, want_p, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want_r, rtol=0, atol=1e-10)
    # without the cached inverse the dispatcher inverts the factor itself
    no_inv = tpost._replace(chol_inv=None)
    np.testing.assert_allclose(
        acq_score(no_inv, torch.as_tensor(anchors), y_best, acq=acq).numpy(),
        got, rtol=0, atol=1e-10,
    )
    # and the torch composition agrees with the fused path
    np.testing.assert_allclose(
        acq_score(tpost, torch.as_tensor(anchors), y_best, acq=acq,
                  backend="torch").numpy(),
        got, rtol=0, atol=1e-10,
    )


def test_acq_score_unbatched_posterior():
    jpost, tpost, anchors, y_best = _posterior(8, 6, 3, 1)
    single = tpost._replace(
        chol=tpost.chol[0], alpha=tpost.alpha[0], chol_inv=tpost.chol_inv[0],
        params=type(tpost.params)(*(p[0] for p in tpost.params)),
    )
    got = acq_score(single, torch.as_tensor(anchors), y_best).numpy()
    want = acq_score(tpost, torch.as_tensor(anchors), y_best).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_cpu_runs_plain_and_counts_no_launch():
    K.reset_launch_counts()
    _, tpost, anchors, y_best = _posterior(8, 5, 2, 2)
    acq_score(tpost, torch.as_tensor(anchors), y_best)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}


def test_cuda_path_raises_without_a_card(monkeypatch):
    """A CUDA tensor launches the kernel or raises — never the plain
    version. With no card visible, the launch path must raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    _, tpost, anchors, y_best = _posterior(8, 5, 2, 2)
    args = pack_inputs(tpost, torch.as_tensor(anchors))
    monkeypatch.setattr(acq_kernel_mod, "check_inputs", lambda *a: "cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        acq_score_kernel(*args, y_best, 2.0, "ei")


def test_wrappers_reject_bad_inputs():
    _, tpost, anchors, y_best = _posterior(8, 5, 2, 2)
    args = list(pack_inputs(tpost, torch.as_tensor(anchors)))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        acq_score_kernel(*meta, y_best, 2.0, "ei")
    with pytest.raises(TypeError, match="dtype"):
        acq_score_kernel(*[a.to(torch.float16) for a in args], y_best, 2.0, "ei")
    bad = list(args)
    bad[3] = bad[3][:, :-1].contiguous()  # alpha one row short
    with pytest.raises(ValueError, match="shape"):
        acq_score_kernel(*bad, y_best, 2.0, "ei")
    grad = list(args)
    grad[0] = grad[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        acq_score_kernel(*grad, y_best, 2.0, "ei")
    with pytest.raises(ValueError, match="unsupported acquisition"):
        acq_score_kernel(*args, y_best, 2.0, "ts")


def test_predict_through_kernel_gram_backend():
    """``backend="kernel"`` grams are float32 (as the TPU kernel's): the
    prediction moves by ~1e-6, not by the algorithm."""
    _, tpost, anchors, _ = _posterior(64, 40, 3, 2)
    mu_k, var_k = TG.predict(tpost, torch.as_tensor(anchors), backend="kernel")
    mu_t, var_t = TG.predict(tpost, torch.as_tensor(anchors), backend="torch")
    np.testing.assert_allclose(mu_k.numpy(), mu_t.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(var_k.numpy(), var_t.numpy(), rtol=0, atol=1e-3)


# ------------------------------------------------ the walk's launch plan
#
# ``walk_plan`` tiles a launch of csrc/acq_walk.cuh. These hold the plan
# itself on the host: its shared memory against the card's 227 KB, the
# choices at the engine's two launch shapes, and — by replaying the
# kernel's index arithmetic in numpy — that its pairs of row blocks, 16-row
# tiles stopped at the triangle and 8-deep k-steps cover every product of
# ‖L⁻¹K*ᵀ‖² exactly once and give the same sum.

from repro_torch.kernels.acq_score.kernel import (  # noqa: E402
    kstar_smem_bytes,
    pairs_of,
    smem_bytes,
    walk_plan,
)

H100_SMEM = 232448  # bytes a block may opt in to (227 KB)
H100_SMS = 132


def _walk_replay(plan, linv, kstar, alphas):
    """‖L⁻¹K*ᵀ‖² (S, m) and μ (S, M, m) as the kernel forms them: block 0
    holds α and the last row block, block p ≥ 1 the row blocks p − 1 and
    R − 1 − p; each warp one 16-row tile of each, k-steps of 8 while k is
    below the tile's last row + 1; warps summed in order, then blocks in
    order. Also returns how often each row was covered and its largest
    k + 1 reached."""
    S, n, _ = linv.shape
    m = kstar.shape[1]
    bm, bk = plan.bm, 16
    R = -(-n // bm)
    ss = np.zeros((S, m))
    mu = None
    covered = np.zeros(n, dtype=int)
    reach = np.zeros(n, dtype=int)
    for p in range(plan.pairs):
        lo, hi = p - 1, R - 1 - p
        kend = min(hi * bm + bm, n)
        nch = -(-kend // bk)
        part = np.zeros((S, m))
        for w in range(bm // 16):
            for blk, on in ((lo, p > 0 and lo != hi), (hi, True)):
                r0 = blk * bm + 16 * w
                if not on or r0 >= n:
                    continue
                rows = np.arange(r0, min(r0 + 16, n))
                covered[rows] += 1
                acc = np.zeros((S, len(rows), m))
                for c in range(nch):
                    for kk in (0, 8):
                        k = c * bk + kk
                        if k < min(r0 + 16, n):
                            ks = slice(k, min(k + 8, n))
                            acc += linv[:, rows, ks] @ kstar[:, :, ks].transpose(0, 2, 1)
                            reach[rows] = np.maximum(reach[rows], min(k + 8, n))
                part += np.sum(acc * acc, axis=1)
        ss += part
        if p == 0:
            assert kend == n  # the α tile's block spans every train row
            mu = alphas @ kstar.transpose(0, 2, 1)
    return ss, mu, covered, reach


@pytest.mark.parametrize("n", [8, 40, 64, 136, 256, 384, 1024])
@pytest.mark.parametrize("m", [8, 200])
def test_walk_plan_covers_the_triangle_once(n, m):
    rng = np.random.default_rng(n + m)
    S, M = 2, 3
    plan = walk_plan(S, m, n, 8, 8, H100_SMS, H100_SMEM)
    assert plan.single == (n <= 64)
    linv = np.tril(rng.standard_normal((S, n, n)))
    kstar = rng.random((S, m, n))
    alphas = rng.standard_normal((S, M, n))
    ss, mu, covered, reach = _walk_replay(plan, linv, kstar, alphas)
    assert (covered == 1).all()
    assert (reach >= np.arange(n) + 1).all()  # every row reaches its diagonal
    assert (reach - (np.arange(n) + 1) < 16).all()  # and stops within its tile
    v = linv @ kstar.transpose(0, 2, 1)
    np.testing.assert_allclose(ss, np.sum(v * v, axis=1), rtol=1e-12, atol=0)
    np.testing.assert_allclose(mu, alphas @ kstar.transpose(0, 2, 1), rtol=1e-12)


@pytest.mark.parametrize("m", [1024, 8])
@pytest.mark.parametrize("elem", [8, 4])
def test_walk_plan_fits_the_card_at_every_bucket(m, elem):
    """Buckets 8…2048, d ≤ 20 (padded to 24), M ≤ 4 heads and W ≤ 16
    draws (the heads share the plan's fixed 16-row α tile; the draws are
    read from device memory): every plan fits 227 KB."""
    for n in [8 * 2**k for k in range(9)]:
        for dp in (8, 16, 24):
            plan = walk_plan(10, m, n, dp, elem, H100_SMS, H100_SMEM)
            assert plan.smem == smem_bytes(plan.ta, plan.bm, n, dp, elem) <= H100_SMEM
            assert kstar_smem_bytes(plan.ta, dp, elem) <= H100_SMEM
            assert plan.pairs == pairs_of(n, plan.bm) == 1 + -(-n // plan.bm) // 2
            assert plan.single == (n <= 64) and (not plan.single or n <= plan.bm <= 64)
            for M in (1, 4):
                npad, mpad = -(-n // 16) * 16, -(-m // plan.ta) * plan.ta
                want = 0
                if not plan.single:  # K*ᵀ, warped anchors and rows
                    want = sum(-(-10 * a * b // 4) * 4
                               for a, b in ((npad, mpad), (mpad, dp), (npad, dp)))
                if plan.pairs > 1:  # the blocks' ‖v‖² partials and the means
                    want += (plan.pairs + M) * 10 * m
                assert plan.workspace(10, m, n, dp, M) == want


def test_walk_plan_at_the_engines_launch_shapes():
    # the anchor grid: the main path's buckets (≤ 64 rows) are single walks
    # of 32 anchors a block, one launch, three blocks an SM (one wave)
    for n, bm in ((8, 16), (16, 16), (32, 32), (64, 64)):
        plan = walk_plan(10, 1024, n, 8, 8, H100_SMS, H100_SMEM)
        assert (plan.ta, plan.bm, plan.pairs, plan.single, plan.blocks) == (
            32, bm, 1, True, 320)
        assert plan.blocks <= 3 * H100_SMS
    # above, a K* pass, then 64 anchors and 128-row blocks in pairs, every
    # block about the same work
    big = walk_plan(10, 1024, 1024, 8, 8, H100_SMS, H100_SMEM)
    assert (big.ta, big.bm, big.pairs, big.single, big.blocks) == (64, 128, 5, False, 800)
    assert walk_plan(10, 1024, 2048, 24, 8, H100_SMS, H100_SMEM).pairs == 9
    # the re-rank: 8 anchors a block; past 64 rows the rows are split until
    # the grid fills the card
    rerank = walk_plan(10, 8, 64, 8, 8, H100_SMS, H100_SMEM)
    assert (rerank.ta, rerank.pairs, rerank.blocks) == (8, 1, 10)
    for n in (1024, 2048):
        plan = walk_plan(10, 8, n, 8, 8, H100_SMS, H100_SMEM)
        assert plan.ta == 8 and plan.blocks >= H100_SMS and plan.bm < 128
    # the main shape's shared memory, array by array (acq_walk.cuh Layout):
    # warped anchors 32 × 9, rows 64 × 8 and the mask (later the ‖v‖²
    # partials and means), K* 64 × 36, three stages of (16 α rows + 64
    # rows) × 20
    assert smem_bytes(32, 64, 64, 8, 8) == 8 * (288 + 512 + 64 + 64 * 36 + 3 * 80 * 20)
    # three single blocks an SM at f64 up to d = 20 (1 KB reserved a block)
    for n in (8, 16, 32, 64):
        plan = walk_plan(10, 1024, n, 24, 8, H100_SMS, H100_SMEM)
        assert 3 * (plan.smem + 1024) <= 233472


def test_walk_plan_raises_naming_the_limit():
    assert walk_plan(10, 1024, 512, 8, 8, H100_SMS, 100_000).bm < 128  # shorter blocks fit
    with pytest.raises(ValueError, match="per block for n=512 rows.*the card allows 20000"):
        walk_plan(10, 1024, 512, 8, 8, H100_SMS, 20_000)
    with pytest.raises(ValueError, match="per K\\* block for d=400.*the card allows 232448"):
        walk_plan(10, 1024, 512, 400, 8, H100_SMS, H100_SMEM)


def test_launch_path_raises_when_no_plan_fits(monkeypatch):
    """The wrapper plans before it launches: a card whose blocks cannot hold
    even 16-row blocks is refused with the limit named, and L⁻¹ off a
    16-byte boundary (cp.async) is refused too."""
    _, tpost, anchors, y_best = _posterior(64, 50, 2, 2)
    args = pack_inputs(tpost, torch.as_tensor(anchors))
    monkeypatch.setattr(acq_kernel_mod, "check_inputs", lambda *a: "cuda")
    monkeypatch.setattr(acq_kernel_mod._build, "library",
                        lambda name: type("Lib", (), {"acq_score_f64": None})())
    monkeypatch.setattr(acq_kernel_mod, "_card", lambda name, dev: (H100_SMS, 20_000))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="the card allows 20000"):
        acq_score_kernel(*args, y_best, 2.0, "ei")
    shifted = list(args)
    shifted[2] = torch.zeros(args[2].numel() + 1, dtype=args[2].dtype)[1:].view(args[2].shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        acq_score_kernel(*shifted, y_best, 2.0, "ei")
