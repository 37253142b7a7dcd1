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
    tpost = convert.posterior_from_numpy(convert.posterior_to_numpy(jpost))
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
