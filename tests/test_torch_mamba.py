"""The port's falcon-mamba-7b pieces and its last two kernels on the CPU,
against the JAX package on the same numpy-seeded inputs.

* ``mamba_scan`` (plain version, which the wrapper runs for CPU tensors)
  against the JAX ``selective_scan`` (Pallas, interpret mode) and the
  oracle ``mamba_scan_ref`` on the sweep of ``tests/test_kernels.py``, at
  its 1e-4; the last state against the final state of the JAX package's
  second scan (``models/model.py::_mamba_prefill``) at 1e-5.
* The arithmetic of the ``mamba_scan`` kernel, which runs only on the card:
  an emulation of its order of operations (exp as 2^(Δ·a·log₂e) in f32,
  FMAs, y summed over 16 zero-padded states in order) against the Pallas
  kernel and the oracle at 1e-4, at d_state 1 and 5 and on a long, slowly
  decaying scan, and against the plain version at every d_state 1–16.
* ``decode_attention`` (plain version) against the JAX ``decode_attention``
  (Pallas, interpret mode) on the sweep of ``tests/test_kernels.py``, a
  soft-capped case, a wrapped ring-buffer mask and a row with no valid
  slot, at the reference's 3e-5 in float32. The empty row gives 0, as the
  Pallas kernel does; the oracle gives the mean of V there (ROADMAP C9), so
  it is compared with the oracle only on rows with a valid slot.
* The rounding of ``decode_attention``'s bf16 tensor-core body, which runs
  only on the card: an emulation of its cache splits, its four warps' keys
  and its two bf16 parts of P, held against the Pallas kernel on bf16
  inputs to the card's per-element bound (|Δ| ≤ 2^-7·|ref| + 2^-9).
* The model: a bfloat16 twin of ``tiny(falcon-mamba-7b)``; the full
  config's parameter count; the initialisation rules; the float32 ``ssm``
  cache through ``lm_cache_from_numpy``. The float32 prefill / decode /
  greedy twins are in ``test_torch_lm_serve.py``.
* The wrappers never fall back from a CUDA tensor (with no card they
  raise) and refuse inputs they do not take.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny as j_tiny
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.mamba_scan.ops import selective_scan as j_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro.models import build_model as j_build_model
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.configs import get_config, tiny
from repro_torch.kernels.decode_attention import kernel as decode_kernel_mod
from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel, split_plan
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.mamba_scan import kernel as scan_kernel_mod
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_kernel, vector_copies
from repro_torch.models import build_model
from repro_torch.models.attention import slot_valid
from repro_torch.models.common import ParamModule, fill_param

torch.backends.cuda.matmul.allow_tf32 = False

NO_LAUNCHES = {name: 0 for name in K.KERNEL_NAMES}


# ------------------------------------------------------------------ mamba_scan
SCAN_CASES = [(2, 64, 128, 8), (1, 300, 256, 16), (2, 128, 300, 16)]


def _scan_inputs(b, s, di, ds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, di)).astype(np.float32),
            (rng.random((b, s, di)) * 0.1).astype(np.float32),
            (-rng.random((di, ds)) * 2).astype(np.float32),
            rng.standard_normal((b, s, ds)).astype(np.float32),
            rng.standard_normal((b, s, ds)).astype(np.float32))


@jax.jit
def _j_final_state(u, dt, a, b_t):
    """The JAX package's second scan of ``_mamba_prefill``: the state after
    the last step."""

    def step(hc, inp):
        u_t, dt_t, b_tt = inp
        a_bar = jnp.exp(dt_t[:, :, None] * a[None, :, :])
        return a_bar * hc + (dt_t * u_t)[:, :, None] * b_tt[:, None, :], None

    h0 = jnp.zeros((u.shape[0], u.shape[2], a.shape[1]), jnp.float32)
    hf, _ = jax.lax.scan(step, h0, (u.swapaxes(0, 1), dt.swapaxes(0, 1), b_t.swapaxes(0, 1)))
    return hf


@pytest.mark.parametrize("b,s,di,ds", SCAN_CASES)
def test_mamba_scan_plain_matches_pallas(b, s, di, ds):
    ins = _scan_inputs(b, s, di, ds, seed=s + di)
    y, h_last = mamba_scan_kernel(*map(torch.as_tensor, ins))
    want = j_scan(*map(jnp.asarray, ins), interpret=True)
    assert y.dtype == torch.float32 and y.shape == (b, s, di)
    assert h_last.dtype == torch.float32 and h_last.shape == (b, di, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert K.LAUNCHES == NO_LAUNCHES


@pytest.mark.parametrize("b,s,di,ds", SCAN_CASES)
def test_mamba_scan_plain_matches_oracle_and_final_state(b, s, di, ds):
    ins = _scan_inputs(b, s, di, ds, seed=s + di)
    y, h_last = mamba_scan_kernel(*map(torch.as_tensor, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(mamba_scan_ref(*map(jnp.asarray, ins))),
                               rtol=0, atol=1e-4)
    u, dt, a, b_t, _ = map(jnp.asarray, ins)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(_j_final_state(u, dt, a, b_t)),
                               rtol=0, atol=1e-5)


def _fma(x, y, z):
    """x·y + z rounded once to float32, as an FMA: the product of two
    floats is exact in float64."""
    return (x.double() * y.double() + z.double()).float()


def mamba_scan_emulated(u, dt, a, b, c):
    """The arithmetic of ``csrc/mamba_scan.cu`` in torch, float32: a₂ =
    a·log₂e once; each step du = Δ·u, exp(Δ·a) as 2^(Δ·a₂) rounded to
    float32, h = fma(2^(Δ·a₂), h, du·b), y an FMA chain over the states in
    order. The states run zero-padded to ``MAX_STATE`` (a₂ = b = c = 0), as
    in the kernel's registers and tiles. u, dt (B, S, di); a (di, ds); b, c
    (B, S, ds) → (y, h_last)."""
    bsz, s, di = u.shape
    ds = a.shape[1]
    width = scan_kernel_mod.MAX_STATE
    a2 = torch.zeros((di, width))
    a2[:, :ds] = a * torch.tensor(1.4426950408889634, dtype=torch.float32)
    bp, cp = (torch.nn.functional.pad(x, (0, width - ds)) for x in (b, c))
    h = torch.zeros((bsz, di, width))
    y = torch.empty_like(u)
    for t in range(s):
        du = (dt[:, t] * u[:, t])[:, :, None]
        h = _fma(torch.exp2(dt[:, t, :, None] * a2[None]), h, du * bp[:, t, None, :])
        yt = torch.zeros((bsz, di))
        for n in range(width):
            yt = _fma(h[..., n], cp[:, t, None, n], yt)
        y[:, t] = yt
    return y, h[..., :ds]


# SCAN_CASES, d_state 1 and 5 (most of the kernel's 16 states padded), and a
# long scan whose state decays slowly (Δ ≈ 0.01), so it carries over the
# sequence
EMULATED_CASES = SCAN_CASES + [(2, 50, 40, 1), (1, 70, 300, 5), (1, 2048, 64, 16)]


@pytest.mark.parametrize("b,s,di,ds", EMULATED_CASES)
def test_mamba_scan_kernel_arithmetic_matches_pallas_and_oracle(b, s, di, ds):
    """The card's order of operations (ex2 of Δ·a·log₂e, FMAs, y summed
    over the padded states in order) within the reference's 1e-4 of the JAX
    ``selective_scan`` (Pallas, interpret mode) and its oracle; the last
    state within 1e-5 of the JAX package's final state."""
    ins = _scan_inputs(b, s, di, ds, seed=s + di + ds)
    if s == 2048:
        ins = (ins[0], (0.01 * (0.9 + 0.2 * np.random.default_rng(3).random((b, s, di))))
               .astype(np.float32)) + ins[2:]
    y, h_last = mamba_scan_emulated(*map(torch.as_tensor, ins))
    jins = tuple(map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(j_scan(*jins, interpret=True)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(mamba_scan_ref(*jins)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(_j_final_state(*jins[:4])),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ds", range(1, scan_kernel_mod.MAX_STATE + 1))
def test_mamba_scan_padded_states_cover_every_state_count(ds):
    """Every d_state from 1 to 16 on the kernel's 16 registers: the states
    padded past ds leave y and the last state as the plain scan gives
    them."""
    ins = tuple(map(torch.as_tensor, _scan_inputs(2, 23, 12, ds, seed=ds)))
    y, h_last = mamba_scan_emulated(*ins)
    y_plain, h_plain = mamba_scan_kernel(*ins)
    assert h_last.shape == h_plain.shape == (2, 12, ds)
    np.testing.assert_allclose(y.numpy(), y_plain.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), h_plain.numpy(), rtol=0, atol=1e-5)


def test_mamba_scan_vector_copies_need_aligned_rows():
    """u and Δ go 16 bytes at a time only when each row is whole 16-byte
    vectors and both tensors start on a 16-byte boundary."""
    u = torch.zeros((2, 5, 64))
    assert vector_copies(u, u.clone())
    assert not vector_copies(torch.zeros((2, 5, 30)), torch.zeros((2, 5, 30)))
    shifted = torch.zeros(2 * 5 * 64 + 1)[1:].view(2, 5, 64)
    assert shifted.is_contiguous() and not vector_copies(shifted, u)
    assert not vector_copies(u, shifted)


# ------------------------------------------------------------ decode_attention
# (b, hq, hkv, dh, c, share of valid slots, softcap): the JAX sweep, then a
# soft-capped case
DECODE_CASES = [(2, 8, 2, 64, 1024, 1.0, 0.0), (1, 16, 1, 128, 2048, 0.5, 0.0),
                (2, 4, 4, 80, 700, 0.8, 0.0), (1, 14, 2, 64, 512, 1.0, 0.0),
                (2, 8, 2, 64, 300, 0.7, 30.0)]


def _qkv(b, hq, hkv, dh, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, dh)).astype(np.float32),
            rng.standard_normal((b, c, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, c, hkv, dh)).astype(np.float32), rng)


def _both(q, k, v, valid, softcap=0.0):
    got = decode_attention(*map(torch.as_tensor, (q, k, v, valid)), softcap=softcap)
    want = j_decode(*map(jnp.asarray, (q, k, v, valid)), softcap=softcap, interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize("b,hq,hkv,dh,c,fv,softcap", DECODE_CASES)
def test_decode_attention_plain_matches_pallas_and_oracle(b, hq, hkv, dh, c, fv, softcap):
    q, k, v, rng = _qkv(b, hq, hkv, dh, c, seed=c + dh)
    valid = rng.random((b, c)) < fv
    valid[:, 0] = True
    got, want = _both(q, k, v, valid, softcap)
    assert got.dtype == torch.float32 and got.shape == (b, hq, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    ref = decode_attention_ref(*map(jnp.asarray, (q, k, v, valid)), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-5)
    assert K.LAUNCHES == NO_LAUNCHES


@pytest.mark.parametrize("t,window", [(100, 48), (40, 64)])
def test_decode_attention_ring_buffer_mask(t, window):
    """The mask ``attention_decode`` builds for a 64-slot ring: wrapped with
    a window narrower than the ring (t = 100), and not yet full (t = 40)."""
    b, hq, hkv, dh, c = 2, 4, 2, 64, 64
    q, k, v, _ = _qkv(b, hq, hkv, dh, c, seed=t)
    row = slot_valid(c, t, window, "cpu").numpy()
    assert 0 < row.sum() < c
    got, want = _both(q, k, v, np.broadcast_to(row, (b, c)).copy())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


def test_decode_attention_row_without_valid_slot_gives_zero():
    """ROADMAP C9: the Pallas kernel gives 0 for a row with no valid slot
    and the port follows it; the oracle's plain softmax gives the mean of V."""
    b, hq, hkv, dh, c = 2, 8, 2, 64, 300
    q, k, v, rng = _qkv(b, hq, hkv, dh, c, seed=9)
    valid = rng.random((b, c)) < 0.6
    valid[1] = False
    got, want = _both(q, k, v, valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    assert float(np.abs(want[1]).max()) == 0.0 and float(got[1].abs().max()) == 0.0
    ref = np.asarray(decode_attention_ref(*map(jnp.asarray, (q, k, v, valid))))
    np.testing.assert_allclose(got.numpy()[0], ref[0], rtol=0, atol=3e-5)
    assert float(np.abs(ref[1]).max()) > 0.05  # the oracle's mean of V


def test_decode_attention_bfloat16():
    """bf16 inputs: both sides softmax and accumulate in f32 and round once
    to bf16, so they differ by at most one bf16 ulp of the value plus f32
    noise: |Δ| ≤ 2^-7·|ref| + 2^-9 per element."""
    q, k, v, rng = _qkv(2, 8, 2, 128, 600, seed=5)
    valid = rng.random((2, 600)) < 0.9
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (jq, jk, jv))
    got = decode_attention(tq, tk, tv, torch.as_tensor(valid))
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_decode(jq, jk, jv, jnp.asarray(valid), interpret=True)
                      .astype(jnp.float32))
    assert np.all(np.abs(got.float().numpy() - want) <= 2.0**-7 * np.abs(want) + 2.0**-9)


def decode_tiles_emulated(q, k, v, valid, softcap=0.0):
    """The arithmetic of the bf16 body of ``csrc/decode_attention.cu`` in
    torch: the cache cut into the splits ``split_plan`` gives bf16 on 132
    SMs; each split's 64-key tiles dealt to four warps of 16 keys; each warp
    an online softmax in f32 over its keys with P as bf16 hi + lo before
    P·V; the warps merged at the end of the split, then the splits. q (B,
    Hq, Dh), k/v (B, C, Hkv, Dh) bf16, valid (B, C) → (B, Hq, Dh) bf16."""
    b, hq, dh = q.shape
    c, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, dh)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, Hkv, C, Dh)
    nsplit, per = split_plan(b, hkv, g, c, 132, torch.bfloat16)
    parts = []
    for sp in range(nsplit):
        warps = []
        for w in range(4):
            m = torch.full((b, hkv, g, 1), -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, hkv, g, dh))
            for t in range(sp * per, min((sp + 1) * per, -(-c // 64))):
                first = t * 64 + 16 * w
                if first >= c:
                    continue
                keys = torch.arange(first, min(first + 16, c))
                sc = qf @ kf[:, :, keys].transpose(-1, -2) * dh**-0.5
                if softcap > 0:
                    sc = softcap * torch.tanh(sc / softcap)
                sc = sc.masked_fill(~valid[:, None, None, keys], -torch.inf)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
                p = torch.exp(sc - m_use)
                hi = p.bfloat16().float()
                pv = hi @ vf[:, :, keys] + (p - hi).bfloat16().float() @ vf[:, :, keys]
                alpha = torch.exp(m - m_use)
                l, acc, m = l * alpha + p.sum(-1, keepdim=True), acc * alpha + pv, m_new
            warps.append((m, l, acc))
        parts.append(_merge(warps))
    m, l, acc = _merge(parts)
    return (acc / l.clamp_min(1e-30)).reshape(b, hq, dh).bfloat16()


def _merge(states):
    """(m, l, acc) of disjoint key sets → theirs together; a set with no
    valid key (m = −∞) drops out."""
    ms = torch.stack([s[0] for s in states])
    big = ms.amax(0)
    w = torch.where(torch.isinf(ms), torch.zeros_like(ms),
                    torch.exp(ms - torch.where(torch.isinf(big), torch.zeros_like(big), big)))
    return (big, (w * torch.stack([s[1] for s in states])).sum(0),
            (w * torch.stack([s[2] for s in states])).sum(0))


# (b, hq, hkv, dh, c, share of valid slots, softcap): the JAX sweep, a
# soft-capped case, and the bf16 cases the card checks — G 1, 2, 3, 7, 8, 16
# at head dims 64, 120, 128, 256, caches ragged against the 64-key tile
DECODE_BF16_CASES = DECODE_CASES + [
    (2, 4, 4, 64, 1000, 0.8, 0.0), (1, 6, 2, 120, 777, 0.5, 0.0),
    (2, 14, 2, 64, 300, 0.7, 0.0), (1, 16, 2, 128, 1001, 1.0, 0.0),
    (2, 16, 1, 256, 700, 0.6, 50.0), (1, 8, 4, 128, 130, 0.05, 0.0)]


@pytest.mark.parametrize("b,hq,hkv,dh,c,fv,softcap", DECODE_BF16_CASES)
def test_decode_bf16_tile_rounding_meets_the_card_bound(b, hq, hkv, dh, c, fv, softcap):
    """The tensor-core body's split, warp and P rounding stay within the
    card's per-element bound of the Pallas kernel on the same bf16 inputs;
    the last batch row has no valid slot where B > 1 and gives 0."""
    q, k, v, rng = _qkv(b, hq, hkv, dh, c, seed=c + dh + 1)
    valid = rng.random((b, c)) < fv
    valid[:, 0] = True
    if b > 1:
        valid[-1] = False
    tq, tk, tv = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    got = decode_tiles_emulated(tq, tk, tv, torch.as_tensor(valid), softcap).float().numpy()
    want = np.asarray(j_decode(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
                               jnp.asarray(valid), softcap=softcap, interpret=True)
                      .astype(jnp.float32))
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 2.0**-9)
    if b > 1:
        assert float(np.abs(got[-1]).max()) == 0.0


@pytest.mark.parametrize("b,hkv,g,c", [(4, 1, 16, 2048), (4, 16, 2, 32768), (1, 2, 7, 70),
                                       (2, 4, 40, 1000)])
def test_decode_bf16_split_plan_fills_the_card(b, hkv, g, c):
    """The tensor-core body's splits: 64-key tiles, none empty, all of
    them covered, and at least one block per SM wherever the cache has
    enough tiles for it (recurrentgemma's ring: 32 splits of one tile)."""
    tiles = -(-c // 64)
    nsplit, per = split_plan(b, hkv, g, c, 132, torch.bfloat16)
    assert nsplit >= 1 and (nsplit - 1) * per < tiles <= nsplit * per
    blocks = b * hkv * -(-g // 16) * nsplit
    assert blocks >= min(132, b * hkv * -(-g // 16) * tiles)


@pytest.mark.parametrize("b,hkv,g,c", [(4, 1, 16, 2048), (4, 16, 2, 32768), (1, 2, 7, 70),
                                       (2, 4, 40, 1000)])
def test_decode_split_plan_covers_the_cache(b, hkv, g, c):
    """The cache splits the wrapper gives the kernel: every split holds at
    least one 32-key tile, together they hold all of them, and the grid
    reaches about two blocks per SM where the cache is long enough."""
    tiles = -(-c // 32)
    nsplit, per = split_plan(b, hkv, g, c, sm_count=132)
    assert nsplit >= 1 and (nsplit - 1) * per < tiles <= nsplit * per
    blocks = b * hkv * -(-g // 16) * nsplit
    assert blocks >= min(2 * 132, b * hkv * -(-g // 16) * -(-tiles // 4))
    assert decode_attention is decode_attention_kernel


# ------------------------------------------------------------------ the model
def _bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


BF16_ULP = 2.0**-8  # one bf16 ulp relative to the value


@pytest.mark.parametrize("impl", [("kernel", "pallas"), ("torch", "xla")],
                         ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_falcon_bfloat16_twin(impl):
    """``tiny(falcon-mamba-7b)`` computing in bfloat16 on both sides, over a
    256-token prompt and 4 decode steps: logits within 4 bf16 ulps of
    max(1, max |logit|), the ``conv`` and float32 ``ssm`` caches within 4
    bf16 ulps of their largest value.

    The two sides round bf16 in different places that neither controls:
    XLA's CPU backend evaluates SiLU one bf16 rounding per op (x·1/(1+e^−x))
    and fuses some of them into their f32 consumers, the port's SiLU rounds
    once. That noise is ~2.5 bf16 ulps of the state's largest value at this
    size. Moving the scan or Δ to bf16 moves the state by 2–9 ulps more at
    S = 256, so a tolerance of 4 catches a scan run in bf16; a D skip or a
    gate rounded once more stays inside the noise and is not seen here."""
    cfg, j_cfg = _bf16(tiny(get_config("falcon-mamba-7b"))), _bf16(j_tiny(j_get_config("falcon-mamba-7b")))
    jmodel = j_build_model(j_cfg, impl=impl[1])
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = convert.load_lm_params(build_model(cfg, impl=impl[0], device="cpu"), jparams)
    rng = np.random.default_rng(1)
    s, steps = 256, 4
    prompt = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    j_logits, j_cache = jax.jit(lambda p, x: jmodel.prefill(p, x, s + steps))(
        jparams, jnp.asarray(prompt))
    logits, caches = model.prefill(prompt, s + steps)

    def close(got, want, scale, what):
        want = np.asarray(want, np.float32)
        err = float(np.abs(np.asarray(got, np.float32) - want).max())
        assert err <= 4 * BF16_ULP * scale(want), f"{what}: max |Δ| {err}"

    rel_logit = lambda w: max(1.0, float(np.abs(w).max()))  # noqa: E731
    rel_state = lambda w: float(np.abs(w).max())  # noqa: E731
    close(logits.numpy(), j_logits, rel_logit, "prefill logits")
    got = convert.lm_cache_to_numpy(cfg, caches)
    want = jax.tree.map(np.asarray, j_cache)
    for group, name in (("stack", "slot0_mamba"), ("leftover", "layer0_mamba")):
        if group not in want:
            continue
        for key in ("conv", "ssm"):
            close(got[group][name][key], want[group][name][key], rel_state, f"{name}.{key}")
    assert caches[0]["conv"].dtype == torch.bfloat16 and caches[0]["ssm"].dtype == torch.float32
    step = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab_size, (2, steps)).astype(np.int32)
    for i in range(steps):
        j_logits, j_cache = step(jparams, j_cache, jnp.asarray(feed[:, i]),
                                 jnp.asarray(s + i, jnp.int32))
        logits, caches = model.decode_step(caches, feed[:, i], s + i)
        close(logits.numpy(), j_logits, rel_logit, f"decode step {i}")


def test_full_falcon_mamba_shapes_without_allocating():
    """The full config builds on the meta device: 64 Mamba layers and the
    JAX package's parameter count, 7,272,665,088."""
    cfg = get_config("falcon-mamba-7b")
    model = build_model(cfg, device="cpu")
    assert model.embed.is_meta
    assert model.kinds == ("mamba",) * 64
    mixer = model.blocks[0].mixer
    assert tuple(mixer.in_proj.shape) == (4096, 2 * 8192)
    assert tuple(mixer.x_proj.shape) == (8192, 256 + 2 * 16)
    assert tuple(mixer.a_log.shape) == (8192, 16)
    abstract = j_build_model(j_get_config("falcon-mamba-7b")).abstract_params()
    j_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abstract))
    assert model.num_params() == j_count == 7_272_665_088


def test_fill_param_knows_the_jax_rules_and_no_other():
    p = torch.empty((3, 5))
    fill_param(p, "ones", 7.0, seed=0, path="x")
    assert torch.equal(p, torch.ones(3, 5))
    fill_param(p, "constant", -4.6, seed=0, path="x")
    assert torch.equal(p, torch.full((3, 5), -4.6))
    fill_param(p, "zeros", 1.0, seed=0, path="x")
    assert float(p.abs().max()) == 0.0
    fill_param(p, "uniform", 0.5, seed=0, path="x")
    assert 0.0 < float(p.abs().max()) <= 0.5
    q = torch.empty((3, 5))
    fill_param(q, "uniform", 0.5, seed=0, path="x")
    assert torch.equal(p, q)
    with pytest.raises(ValueError, match="unknown init"):
        fill_param(p, "xavier", 1.0, seed=0, path="x")
    with pytest.raises(ValueError, match="unknown init"):
        ParamModule().declare("w", (2,), init="xavier")


def test_seeded_falcon_init_matches_the_jax_constants():
    """The rules that are not random give the JAX init's values exactly:
    D skip 1, a_log 0 (A = −(n+1)), dt_proj_b −4.6, conv_b 0."""
    cfg = tiny(get_config("falcon-mamba-7b"))
    model = build_model(cfg, device="cpu").init(5)
    jparams = j_build_model(j_tiny(j_get_config("falcon-mamba-7b"))).init(jax.random.PRNGKey(5))
    state = convert.lm_params_from_numpy(cfg, jparams)
    for i in range(cfg.num_layers):
        for key in ("d_skip", "a_log", "dt_proj_b", "conv_b"):
            name = f"blocks.{i}.mixer.{key}"
            np.testing.assert_array_equal(dict(model.named_parameters())[name].numpy(),
                                          state[name], err_msg=name)
    assert float(model.blocks[0].mixer.d_skip.min()) == 1.0
    assert float(model.blocks[0].mixer.in_proj.std()) > 0.0


def test_lm_cache_from_numpy_keeps_ssm_in_float32():
    cfg = _bf16(tiny(get_config("falcon-mamba-7b")))
    j_cfg = _bf16(j_tiny(j_get_config("falcon-mamba-7b")))
    jmodel = j_build_model(j_cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _, j_cache = jax.jit(lambda p, x: jmodel.prefill(p, x, 16))(jparams, jnp.asarray(prompt))
    caches = convert.lm_cache_from_numpy(cfg, jax.tree.map(np.asarray, j_cache),
                                         torch.bfloat16, "cpu")
    fresh = build_model(cfg, device="cpu").init_cache(2, 16)
    for got, new in zip(caches, fresh):
        assert got["ssm"].dtype == new["ssm"].dtype == torch.float32
        assert got["conv"].dtype == new["conv"].dtype == torch.bfloat16
        assert got["ssm"].shape == new["ssm"].shape
    want = np.asarray(j_cache["stack"]["slot0_mamba"]["ssm"][0])
    np.testing.assert_array_equal(caches[0]["ssm"].numpy(), want)


# ------------------------------------------------------------------ wrappers
def test_cuda_path_raises_without_a_card(monkeypatch):
    """A CUDA tensor launches the kernel or raises — never the plain
    version. With no card visible, both launch paths must raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    ins = list(map(torch.as_tensor, _scan_inputs(1, 40, 8, 4, seed=1)))
    q, k, v, _ = _qkv(1, 4, 2, 64, 50, seed=1)
    valid = torch.ones((1, 50), dtype=torch.bool)
    monkeypatch.setattr(scan_kernel_mod, "check_inputs", lambda *args: "cuda")
    monkeypatch.setattr(decode_kernel_mod, "check_inputs", lambda *args: "cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        mamba_scan_kernel(*ins)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        decode_attention(*map(torch.as_tensor, (q, k, v)), valid)
    # the kernels' own limits are checked before they are loaded
    wide = list(map(torch.as_tensor, _scan_inputs(1, 40, 8, 17, seed=1)))
    with pytest.raises(ValueError, match="d_state 17"):
        mamba_scan_kernel(*wide)
    q6, k6, v6, _ = _qkv(1, 4, 2, 6, 50, seed=1)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(*map(torch.as_tensor, (q6, k6, v6)), valid)
    assert K.LAUNCHES == NO_LAUNCHES


def test_wrappers_reject_bad_inputs():
    u, dt, a, b_t, c_t = map(torch.as_tensor, _scan_inputs(1, 40, 8, 4, seed=2))
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 4, 2, 16, 50, seed=2)[:3])
    valid = torch.ones((1, 50), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no backward pass"):
        mamba_scan_kernel(u.clone().requires_grad_(True), dt, a, b_t, c_t)
    with pytest.raises(TypeError, match="dtype"):
        mamba_scan_kernel(*(x.double() for x in (u, dt, a, b_t, c_t)))
    with pytest.raises(ValueError, match="shape"):
        mamba_scan_kernel(u, dt, a, b_t[:, :-1].contiguous(), c_t)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_kernel(u, dt, a, b_t, c_t.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(RuntimeError, match="no backward pass"):
        decode_attention(q.clone().requires_grad_(True), k, v, valid)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q.double(), k.double(), v.double(), valid)
    with pytest.raises(ValueError, match="query heads"):
        decode_attention(q[:, :3].contiguous(), k, v, valid)
    with pytest.raises(ValueError, match="valid must be bool"):
        decode_attention(q, k, v, valid.int())
    with pytest.raises(ValueError, match="valid must be bool"):
        decode_attention(q, k, v, valid[:, :-1])
    with pytest.raises(ValueError, match="no slot"):
        decode_attention(q, k[:, :0].contiguous(), v[:, :0].contiguous(), valid[:, :0])
