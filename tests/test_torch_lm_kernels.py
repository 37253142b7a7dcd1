"""The port's LM kernels on the CPU (their plain versions) against the JAX
package's Pallas kernels (interpret mode) and oracles, on the same
numpy-seeded inputs, at the cases and tolerances of ``tests/test_kernels.py``:

* ``flash_attention`` (causal / windowed GQA attention with softcap): 3e-5
  in float32, 2e-2 in bfloat16 (one bf16 rounding of the output);
* ``rglru_scan`` (h = a·h + g): 1e-4, and 1e-3 for the extreme decays;
  the port's kernel also returns the last state, which must be h[:, −1];
* the rounding of the bf16 tensor-core body of ``flash_attention``, which
  runs only on the card: an emulation of its tile order and its two bf16
  parts of P, held against the Pallas kernel on bf16 inputs to the per-
  element bound the card holds it to (|Δ| ≤ 2^-7·|ref| + 2^-9);
* training's flash-attention pair on the CPU (the forward with the LSE,
  the plain backward's explicit formulas, ``FlashAttentionTrain``): the
  output and the q, k, v gradients against ``jax.vjp`` of the JAX
  package's oracle, float32 to 1e-5.

The wrappers never fall back from a CUDA tensor (with no card they raise),
refuse inputs that require a gradient, and launch nothing on the CPU.
"""

import jax
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
from repro_torch.kernels.flash_attention.plain import (
    flash_attention_bwd_plain, flash_attention_plain,
)
from repro_torch.kernels.flash_attention.train import FlashAttentionTrain
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


# bf16 attention on the card is held per element: |Δ| ≤ REL·|ref| + ABS
# (chip_smoke.py's TOL_ELEM)
REL, ABS = 2.0**-7, 2.0**-9


def flash_tiles_emulated(q, k, v, window=0, softcap=0.0, split_p=True):
    """The arithmetic of the bf16 body of ``csrc/flash_attention.cu`` in
    torch: 128-row query blocks walk the 64-key tiles that meet their band in
    order; per tile, f32 scores and an online softmax; P rounded to bf16
    before P·V — as the kernel does, as hi = bf16(p) plus lo = bf16(p − hi)
    (``split_p``), or once. q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh), bf16 →
    (B, S, Hq, Dh) bf16."""
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (x.float().permute(0, 2, 1, 3).repeat_interleave(g, 1) for x in (k, v))
    out = torch.empty_like(qf)
    for q0 in range(0, s, 128):
        rows = torch.arange(q0, min(q0 + 128, s))
        m = torch.full((b, hq, len(rows), 1), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, len(rows), dh))
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        for t in range(k_lo // 64, int(rows[-1]) // 64 + 1):
            keys = torch.arange(t * 64, min(t * 64 + 64, s))
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * dh**-0.5
            if softcap > 0:
                sc = softcap * torch.tanh(sc / softcap)
            diff = rows[:, None] - keys[None, :]
            live = (diff >= 0) & ((diff < window) if window > 0 else True)
            sc = sc.masked_fill(~live, -torch.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
            p = torch.exp(sc - m_use)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, :, keys]
            if split_p:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, :, keys]
            alpha = torch.exp(m - m_use)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


def worst_of_limit(got, want) -> float:
    """max over elements of |got − want| / (REL·|want| + ABS): at most 1
    passes the card's per-element bound."""
    got, want = (torch.as_tensor(np.asarray(x, np.float64)) for x in (got, want))
    return float(((got - want).abs() / (REL * want.abs() + ABS)).max())


def _bf16_qkv(b, s, hq, hkv, dh, seed):
    """numpy-seeded inputs rounded to bf16: the torch tensors and the same
    values as JAX bf16 arrays."""
    ts = [torch.as_tensor(x).bfloat16() for x in _qkv(b, s, hq, hkv, dh, seed)]
    return ts, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


@pytest.mark.parametrize("b,s,hq,hkv,dh,window,softcap",
                         FLASH_CASES + [(1, 640, 4, 1, 256, 512, 0.0)])
def test_flash_bf16_tile_rounding_meets_the_card_bound(b, s, hq, hkv, dh, window, softcap):
    """The tensor-core body's one new rounding point, P in bf16 (as hi + lo)
    in its tile order, stays within the card's per-element bound of the
    Pallas kernel's f32 softmax on the same bf16 inputs; the long band (S =
    640, window 512, Dh 256) is the serving shape's kind."""
    (tq, tk, tv), (jq, jk, jv) = _bf16_qkv(b, s, hq, hkv, dh, seed=s + dh + 1)
    got = flash_tiles_emulated(tq, tk, tv, window, softcap).float().numpy()
    want = np.asarray(j_flash(jq, jk, jv, window=window, softcap=softcap, interpret=True)
                      .astype(jnp.float32))
    assert worst_of_limit(got, want) <= 1.0


def test_flash_bf16_split_p_is_closer_than_one_rounding():
    """Why the kernel splits P: on a band of few keys per row (window 9),
    where one weight moves an output most, the bf16 hi + lo parts stay
    closer to the f32 softmax than one bf16 rounding of P."""
    (tq, tk, tv), _ = _bf16_qkv(2, 300, 4, 1, 64, seed=21)
    want = flash_attention_kernel(tq.float(), tk.float(), tv.float(), window=9).numpy()
    split = worst_of_limit(flash_tiles_emulated(tq, tk, tv, 9).float().numpy(), want)
    once = worst_of_limit(flash_tiles_emulated(tq, tk, tv, 9, split_p=False).float().numpy(),
                          want)
    assert split <= 1.0 and split < once


@pytest.mark.parametrize("scale", [None, 1 / 128], ids=["dh^-1/2", "1/128"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_train_gradients_match_the_oracle(dh, g, window, softcap, scale):
    """Training's pair on the CPU against ``jax.vjp`` of the JAX package's
    oracle on the same q, k, v and upstream gradient, float32 to 1e-5: the
    forward with the LSE and the plain backward called directly, and
    ``FlashAttentionTrain`` through autograd. The oracle scales the scores
    by Dh^-1/2; another scale enters it as q·(scale·Dh^1/2)."""
    q, k, v = _qkv(2, 70, 2 * g, 2, dh, seed=dh + 7 * g + window)
    do = np.random.default_rng(dh + g).standard_normal(q.shape).astype(np.float32)
    sc = dh**-0.5 if scale is None else scale
    c = sc * dh**0.5

    def oracle(q, k, v):
        return _tr(flash_attention_ref(_tr(q * c), _tr(k), _tr(v), window=window,
                                       softcap=softcap))

    want_out, vjp = jax.vjp(oracle, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, window, softcap, sc, lse=True)
    direct = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, window, softcap, sc)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    pair_out = FlashAttentionTrain.apply(*leaves, window, softcap, sc)
    pair = torch.autograd.grad(pair_out, leaves, tdo)
    for got in (out, pair_out.detach()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for grads in (direct, pair):
        for got, w in zip(grads, want):
            assert got.dtype == torch.float32 and got.shape == w.shape
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}


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


def test_bf16_head_dims_the_tensor_core_bodies_refuse(monkeypatch):
    """bf16 launches only the tensor-core bodies, which take rows of whole
    16-byte chunks (Dh a multiple of 8): Dh = 12 raises in bf16 before
    anything is loaded, where f32 (the SIMT bodies, Dh a multiple of 4)
    goes on to the launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    from repro_torch.kernels.decode_attention import kernel as decode_kernel_mod
    from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel

    monkeypatch.setattr(flash_kernel_mod, "check_inputs", lambda *args: "cuda")
    monkeypatch.setattr(decode_kernel_mod, "check_inputs", lambda *args: "cuda")
    q, k, v = map(torch.as_tensor, _qkv(1, 40, 2, 1, 12, seed=4))
    valid = torch.ones((1, 40), dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention_kernel(q[:, 0].bfloat16(), k.bfloat16(), v.bfloat16(), valid)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        flash_attention_kernel(q, k, v)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        decode_attention_kernel(q[:, 0].contiguous(), k, v, valid)
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


if __name__ == "__main__":
    # The emulation at the serving shape's band with four of its sixteen
    # heads, against the plain f32 softmax (what the card compares the
    # kernel with): the worst element's share of its bound, P split in two
    # bf16 parts (the kernel) and P rounded once.
    (tq, tk, tv), _ = _bf16_qkv(1, 3000, 4, 1, 256, seed=2024)
    ref = flash_attention_kernel(tq, tk, tv, window=2048).float().numpy()
    for split_p in (True, False):
        got = flash_tiles_emulated(tq, tk, tv, 2048, split_p=split_p).float().numpy()
        print(f"split_p={split_p}: worst element {worst_of_limit(got, ref):.3f} of its limit")
