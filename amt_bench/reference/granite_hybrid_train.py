"""Plain reference of the hybrid Granite cells' training step (granite 4.0-H:
Mamba-2 mixers, NoPE attention, an MoE with a shared expert), in float32
PyTorch with TF32 off.

Written from the published equations (the Mamba-2 paper, HF
``granitemoehybrid``); it imports nothing of the program. The settings come
from the configuration file through ``inputs/granite_hybrid.py``'s
``settings``. A layer is

    h = x + m·mixer(rms(x, ln1)),   out = h + m·(moe(rms(h, ln2)) + shared(rms(h, ln2)))

with m = ``residual_multiplier``; the model embeds ×``embedding_multiplier``,
ends with rms(·, final_norm) and the tied head ÷``logits_scaling``, and its
loss is the mean token cross-entropy plus the layers' aux losses.

* RMSNorm: x·rsqrt(mean x² + ε)·(1 + γ). (Departure: HF stores the gain
  itself, initialised to 1; here and in the program it is stored as 1 + γ.)
* Mamba-2 mixer: [z, xBC, dt] = x·W_in; xBC through the causal depthwise
  conv of width d_conv with bias (out_t = b + Σ_i w_i·xBC_{t−d_conv+1+i}),
  SiLU, split into x (H×P), B and C (G×N); Δ = softplus(dt + dt_bias),
  A = −exp(A_log); the recurrence S_t = exp(Δ_t A)·S_{t−1} + Δ_t x_t⊗B_t,
  y_t = S_t·C_t + D·x_t, head h reading group h // (H/G); then
  rms(y ⊙ SiLU(z), norm) over the H·P channels and ·W_out. The recurrence
  runs here in time blocks of ``BLOCK`` steps — a length other than the
  program's chunk — one block after another: inside a block its quadratic
  form, the state carried from block to block in a Python loop.
* Attention: GQA without position embeddings (NoPE), scores
  q·k × ``attention_multiplier``, causal softmax.
* MoE: the router scores all ``router_experts`` (softmax), the k largest
  (a stable sort, the lower expert first on a tie) renormalized — HF's
  softmax over the chosen logits; the chip holds ``num_local_experts`` of
  them from ``first_held`` and computes their SwiGLU outputs only; a pair
  routed to an expert held elsewhere adds nothing here. Capacity (assumed:
  HF routes without drops) C = ⌈T·k/E·cf⌉ slots an expert, each pair in
  token-major order taking its expert's next slot, a pair past C dropped;
  the Switch aux loss E·Σ f_e·P_e·w over all E (f_e without gradient). The
  shared expert is SiLU(x·W1) ⊙ (x·W3) · W2 on every token.

The step (microbatches, clipping, AdamW) and the float8 control
(``quant=True``: every matrix product's operands rounded to e4m3 with one
scale a tensor) are ``reference/lm_train.py``'s. Layers are checkpointed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from amt_bench.reference.lm_train import Reference as _Step
from amt_bench.reference.lm_train import _q8

#: time steps a block of the reference's recurrence
BLOCK = 128


class Reference(_Step):
    """``Reference(settings, optimizer, weights, quant=False)``: the settings
    are ``inputs/granite_hybrid.py``'s, the weights the program's names."""

    def _rms(self, x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.m["eps"]) * (1.0 + g)

    # ------------------------------------------------------------ mixers
    def _recurrence(self, xs, dt, a, bm, cm):
        """y of the recurrence (no D skip): xs (B, S, H, P), dt (B, S, H),
        a (H,), bm, cm (B, S, H, N) — each head's own B and C."""
        bsz, s, h, p = xs.shape
        state = xs.new_zeros(bsz, h, p, bm.shape[-1])
        out = []
        for t0 in range(0, s, BLOCK):
            x_b, dt_b = xs[:, t0:t0 + BLOCK], dt[:, t0:t0 + BLOCK]
            b_b, c_b = bm[:, t0:t0 + BLOCK], cm[:, t0:t0 + BLOCK]
            n = x_b.shape[1]
            run = torch.cumsum(dt_b * a, dim=1)  # (B, n, H): Σ Δ·A through each step
            gap = run.permute(0, 2, 1)[:, :, :, None] - run.permute(0, 2, 1)[:, :, None, :]
            lower = torch.ones(n, n, dtype=torch.bool, device=xs.device).tril()
            weight = torch.exp(gap.masked_fill(~lower, float("-inf")))  # (B, H, n, n)
            dx = dt_b[..., None] * x_b  # (B, n, H, P)
            cb = torch.einsum("bihn,bjhn->bhij", c_b, b_b)
            y = torch.einsum("bhij,bjhp->bihp", self._q(cb * weight), self._q(dx))
            y = y + torch.einsum("bihn,bhpn->bihp", self._q(c_b), self._q(state)) \
                * torch.exp(run)[..., None]
            to_end = torch.exp(run[:, -1:] - run)  # (B, n, H)
            state = torch.exp(run[:, -1])[:, :, None, None] * state + torch.einsum(
                "bjhp,bjhn->bhpn", self._q(to_end[..., None] * dx), self._q(b_b))
            out.append(y)
        return torch.cat(out, dim=1)

    def _q(self, t):
        """A product's operand: as it is, or in float8 for the control."""
        return _q8(t) if self.quant else t

    def _mamba(self, h, i):
        m, w = self.m, self.w
        pre = f"blocks.{i}.mixer."
        bsz, s, d = h.shape
        heads, hp, n, g, dc = m["heads"], m["head_dim"], m["d_state"], m["groups"], m["d_conv"]
        di = heads * hp
        proj = self._mm(h.reshape(bsz * s, d), w[pre + "in_proj"]).view(bsz, s, -1)
        z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, heads], dim=-1)
        conv_w = w[pre + "conv_w"]  # (d_conv, channels)
        padded = F.pad(xbc, (0, 0, dc - 1, 0))
        xbc = w[pre + "conv_b"] + sum(conv_w[j] * padded[:, j:j + s] for j in range(dc))
        xs, bm, cm = torch.split(F.silu(xbc), [di, g * n, g * n], dim=-1)
        xs = xs.reshape(bsz, s, heads, hp)
        per_group = heads // g
        bm = bm.reshape(bsz, s, g, n).repeat_interleave(per_group, dim=2)
        cm = cm.reshape(bsz, s, g, n).repeat_interleave(per_group, dim=2)
        delta = F.softplus(dt + w[pre + "dt_bias"])
        a = -torch.exp(w[pre + "a_log"])
        y = self._recurrence(xs, delta, a, bm, cm) + w[pre + "d_skip"][:, None] * xs
        gated = y.reshape(bsz, s, di) * F.silu(z)
        normed = self._rms(gated, w[pre + "norm"])
        return self._mm(normed.reshape(bsz * s, di), w[pre + "out_proj"]).view(bsz, s, d)

    def _attention(self, h, i):
        m, w = self.m, self.w
        b, s, d = h.shape
        hq, hkv, dh = m["hq"], m["hkv"], m["dh"]
        pre = f"blocks.{i}.attn."
        flat = h.reshape(b * s, d)
        q = self._mm(flat, w[pre + "wq"].reshape(d, hq * dh)).view(b, s, hq, dh)
        k = self._mm(flat, w[pre + "wk"].reshape(d, hkv * dh)).view(b, s, hkv, dh)
        v = self._mm(flat, w[pre + "wv"].reshape(d, hkv * dh)).view(b, s, hkv, dh)
        rep = hq // hkv
        q = q.transpose(1, 2)
        k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
        v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
        scores = self._mm(q, k.transpose(-1, -2)) * m["attn_scale"]
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = self._mm(probs, v).transpose(1, 2).reshape(b * s, hq * dh)
        return self._mm(out, w[pre + "wo"].reshape(hq * dh, d)).view(b, s, d)

    # --------------------------------------------------------------- FFN
    def _swiglu(self, x, w1, w3, w2):
        return self._mm(F.silu(self._mm(x, w1)) * self._mm(x, w3), w2)

    def _moe(self, h, i):
        m, w = self.m, self.w
        e, k, held, first = m["experts"], m["top_k"], m["held"], m["first_held"]
        t = h.shape[0]
        pre = f"blocks.{i}.mlp."
        probs = torch.softmax(self._mm(h, w[pre + "router"]), dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :k], top_e[:, :k]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = int(math.ceil(t * k / e * m["capacity_factor"]))
        e_flat = top_e.reshape(-1)  # token-major, choice-minor
        onehot = F.one_hot(e_flat, e)
        slot = (torch.cumsum(onehot, 0) - onehot).gather(1, e_flat[:, None])[:, 0]
        keep = slot < cap
        f_e = F.one_hot(top_e[:, 0], e).float().mean(0)
        aux = e * torch.sum(f_e * probs.mean(0)) * m["aux_loss_weight"]
        tok = torch.arange(t, device=h.device).repeat_interleave(k)
        weight = top_p.reshape(-1)
        out = torch.zeros_like(h)
        for j in range(held):
            sel = torch.nonzero((e_flat == first + j) & keep)[:, 0]
            rows = tok[sel]
            y = self._swiglu(h[rows], w[pre + "w1"][j], w[pre + "w3"][j], w[pre + "w2"][j])
            out = out.index_add(0, rows, y * weight[sel][:, None])
        shared = self._swiglu(h, w[pre + "shared_w1"], w[pre + "shared_w3"], w[pre + "shared_w2"])
        return out + shared, aux

    def _layer(self, x, i: int):
        m = self.m
        mixer = self._mamba if m["kinds"][i] == "mamba" else self._attention
        x = x + m["res_mult"] * mixer(self._rms(x, self.w[f"blocks.{i}.ln1"]), i)
        b, s, d = x.shape
        y, aux = self._moe(self._rms(x, self.w[f"blocks.{i}.ln2"]).reshape(b * s, d), i)
        return x + m["res_mult"] * y.view(b, s, d), aux

    def loss(self, inputs: torch.Tensor, labels: torch.Tensor):
        """(loss, cross-entropy, aux) of one microbatch (B, S)."""
        m = self.m
        x = self.w["embed"][inputs] * m["embed_mult"]
        aux = torch.zeros((), device=x.device)
        for i in range(len(m["kinds"])):
            x, a = checkpoint(self._layer, x, i, use_reentrant=False)
            aux = aux + a
        x = self._rms(x, self.w["final_norm"])
        logits = self._mm(x.reshape(-1, x.shape[-1]), self.w["embed"].T) / m["logits_scaling"]
        ce = (torch.logsumexp(logits, -1) - logits.gather(1, labels.reshape(-1, 1))[:, 0]).mean()
        return ce + aux, ce, aux
