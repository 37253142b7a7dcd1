"""The port's LM kernels on the CPU (their plain versions) against the JAX
package's Pallas kernels (interpret mode) and oracles, on the same
numpy-seeded inputs, at the cases and tolerances of ``tests/test_kernels.py``:

* ``flash_attention`` (causal / windowed GQA attention with softcap): 3e-5
  in float32, 2e-2 in bfloat16 (one bf16 rounding of the output);
* ``rglru_scan`` (h = a·h + g): 1e-4, and 1e-3 for the extreme decays;
  the port's kernel also returns the last state, which must be h[:, −1].

The wrappers never fall back from a CUDA tensor (with no card they raise),
refuse inputs that require a gradient, and launch nothing on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.rglru_scan.ops import rglru_scan as j_rglru
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import kernel as flash_kernel_mod
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel_mod
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLASH_CASES = [
    (2, 128, 4, 2, 64, 0, 0.0),
    (1, 256, 8, 1, 128, 0, 0.0),
    (2, 384, 6, 2, 80, 100, 0.0),
    (1, 200, 2, 2, 64, 0, 0.0),
    (2, 256, 4, 2, 64, 0, 30.0),
    (1, 130, 4, 4, 96, 64, 20.0),
]


def _tr(x):
    return jnp.transpose(x, (0, 2, 1, 3))


def _qkv(b, s, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,dh,window,softcap", FLASH_CASES)
def test_flash_plain_matches_pallas(b, s, hq, hkv, dh, window, softcap):
    q, k, v = _qkv(b, s, hq, hkv, dh, seed=s + dh)
    got = flash_attention_kernel(*map(torch.as_tensor, (q, k, v)), window=window, softcap=softcap)
    want = j_flash(*map(jnp.asarray, (q, k, v)), window=window, softcap=softcap,
                   interpret=True)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}


@pytest.mark.parametrize("b,s,hq,hkv,dh,window,softcap", FLASH_CASES)
def test_flash_plain_matches_oracle(b, s, hq, hkv, dh, window, softcap):
    q, k, v = _qkv(b, s, hq, hkv, dh, seed=s + dh)
    got = flash_attention_kernel(*map(torch.as_tensor, (q, k, v)), window=window, softcap=softcap)
    want = _tr(flash_attention_ref(*(_tr(jnp.asarray(x)) for x in (q, k, v)),
                                   window=window, softcap=softcap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 3e-5)])
def test_flash_dtypes(dtype, tol):
    q, k, v = _qkv(1, 256, 4, 2, 128, seed=7)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    # the same (rounded) inputs on both sides
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    got = flash_attention_kernel(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    pal = np.asarray(j_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    ref = np.asarray(_tr(flash_attention_ref(_tr(jq), _tr(jk), _tr(jv))).astype(jnp.float32))
    np.testing.assert_allclose(got, pal, rtol=0, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("window", [1, 9, 40])
def test_flash_narrow_window(window):
    """A band narrower than a 32-key tile, and wider, over a ragged S: the
    tiles the kernel walks and the mask inside them."""
    q, k, v = _qkv(1, 70, 4, 1, 16, seed=3)
    got = flash_attention_kernel(*map(torch.as_tensor, (q, k, v)), window=window)
    want = j_flash(*map(jnp.asarray, (q, k, v)), window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)


RGLRU_CASES = [(2, 64, 128), (1, 500, 256), (2, 129, 300)]


def _ag(b, s, di, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 0.9999, (b, s, di)).astype(np.float32),
            rng.standard_normal((b, s, di)).astype(np.float32))


@pytest.mark.parametrize("b,s,di", RGLRU_CASES)
def test_rglru_plain_matches_pallas(b, s, di):
    a, g = _ag(b, s, di, seed=s)
    got, _ = rglru_scan_kernel(torch.as_tensor(a), torch.as_tensor(g))
    want = j_rglru(jnp.asarray(a), jnp.asarray(g), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (b, s, di)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}


@pytest.mark.parametrize("b,s,di", RGLRU_CASES)
def test_rglru_plain_matches_oracle_and_returns_last_state(b, s, di):
    a, g = _ag(b, s, di, seed=s)
    h, h_last = rglru_scan_kernel(torch.as_tensor(a), torch.as_tensor(g))
    want = np.asarray(rglru_scan_ref(jnp.asarray(a), jnp.asarray(g)))
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=1e-4)
    assert h_last.shape == (b, di)
    np.testing.assert_array_equal(h_last.numpy(), h[:, -1].numpy())


def test_rglru_extreme_decays():
    """Near-0 and near-1 decays over a long sequence (stability)."""
    b, s, di = 1, 384, 256
    a = np.concatenate([np.full((b, s, di // 2), 0.9999, np.float32),
                        np.full((b, s, di // 2), 1e-4, np.float32)], axis=-1)
    g = np.random.default_rng(11).standard_normal((b, s, di)).astype(np.float32)
    got = rglru_scan_kernel(torch.as_tensor(a), torch.as_tensor(g))[0].numpy()
    pal = np.asarray(j_rglru(jnp.asarray(a), jnp.asarray(g), interpret=True))
    ref = np.asarray(rglru_scan_ref(jnp.asarray(a), jnp.asarray(g)))
    np.testing.assert_allclose(got, pal, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_cuda_path_raises_without_a_card(monkeypatch):
    """A CUDA tensor launches the kernel or raises — never the plain
    version. With no card visible, both launch paths must raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    q, k, v = map(torch.as_tensor, _qkv(1, 40, 2, 1, 16, seed=1))
    a, g = map(torch.as_tensor, _ag(1, 40, 8, seed=1))
    monkeypatch.setattr(flash_kernel_mod, "check_inputs", lambda *args: "cuda")
    monkeypatch.setattr(rglru_kernel_mod, "check_inputs", lambda *args: "cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        flash_attention_kernel(q, k, v, window=8)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        rglru_scan_kernel(a, g)
    # the kernel's own limits are checked before it is loaded
    q6, k6, v6 = map(torch.as_tensor, _qkv(1, 40, 2, 1, 6, seed=1))
    with pytest.raises(ValueError, match="multiple of 4"):
        flash_attention_kernel(q6, k6, v6)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}


def test_wrappers_reject_bad_inputs():
    q, k, v = map(torch.as_tensor, _qkv(1, 40, 4, 2, 16, seed=2))
    a, g = map(torch.as_tensor, _ag(1, 40, 8, seed=2))
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention_kernel(q.clone().requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="no backward pass"):
        rglru_scan_kernel(a.clone().requires_grad_(True), g)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_kernel(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        rglru_scan_kernel(a.bfloat16(), g.bfloat16())
    with pytest.raises(TypeError, match="input 1"):
        flash_attention_kernel(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="query heads"):
        flash_attention_kernel(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan_kernel(a, g[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_kernel(a.transpose(1, 2).contiguous().transpose(1, 2), g)
