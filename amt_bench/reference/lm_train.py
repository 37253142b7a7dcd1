"""Plain reference of the LM cells' training step, in float32 PyTorch.

Written from the configuration's equations; it imports nothing of the
program. A pre-norm decoder: RMSNorm with gain (1 + γ) and ε 1e-6; grouped
attention (query head h reads key/value head h // (Hq/Hkv)) with rotary
embeddings (half-split, θ 10⁴) and a causal softmax; a top-k mixture of
SwiGLU experts with capacity slots — the k largest router probabilities (a
stable sort, the lower expert first on a tie) renormalized, each (token,
choice) pair in token-major order taking its expert's next slot, a pair past
C = ⌈T·k/E·1.25⌉ dropped — and the Switch load-balancing loss
E·Σ_e f_e·P_e·0.01 (f_e the share of tokens whose first choice is e, without
gradient; P_e the mean router probability); tied embeddings; mean token
cross-entropy plus the layers' aux losses. A step splits its batch into
contiguous microbatches (capacity counted within each), averages their
losses and gradients, clips the gradient to global norm 1 and applies AdamW
(decoupled weight decay, bias-corrected moments, warmup then cosine).

``quant=True`` is the lower-precision control: every matrix product's
operands rounded to float8 e4m3 with one scale a tensor (the range's max
over 448), gradients passed straight through.

Layers are checkpointed (recomputed in the backward pass) so that a
microbatch of the cells' size fits beside the weights and moments.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _q8(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:  # an expert no token chose
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (xq - x).detach()


class Reference:
    def __init__(self, model: dict, optimizer: dict, weights: Dict[str, torch.Tensor],
                 quant: bool = False):
        self.m, self.opt, self.quant = model, optimizer, quant
        self.w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        self.mom = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.vel = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.steps = 0

    # ------------------------------------------------------------ forward
    def _mm(self, a, b):
        if self.quant:
            a, b = _q8(a), _q8(b)
        return a @ b

    def _rms(self, x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.m["norm_eps"]) * (1.0 + g)

    def _rope(self, x, pos):
        dh = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                                           device=x.device) / dh))
        ang = pos[:, None].float() * inv  # (S, dh/2)
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
        x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, h, i):
        m, w = self.m, self.w
        b, s, d = h.shape
        hq, hkv, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        pre = f"blocks.{i}.attn."
        flat = h.reshape(b * s, d)
        q = self._mm(flat, w[pre + "wq"].reshape(d, hq * dh)).view(b, s, hq, dh)
        k = self._mm(flat, w[pre + "wk"].reshape(d, hkv * dh)).view(b, s, hkv, dh)
        v = self._mm(flat, w[pre + "wv"].reshape(d, hkv * dh)).view(b, s, hkv, dh)
        pos = torch.arange(s, device=h.device)
        q, k = self._rope(q, pos), self._rope(k, pos)
        g = hq // hkv
        q = q.transpose(1, 2)  # (B, Hq, S, Dh)
        k = k.transpose(1, 2).repeat_interleave(g, dim=1)
        v = v.transpose(1, 2).repeat_interleave(g, dim=1)
        scores = self._mm(q, k.transpose(-1, -2)) * dh ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = self._mm(probs, v).transpose(1, 2).reshape(b * s, hq * dh)
        return self._mm(out, w[pre + "wo"].reshape(hq * dh, d)).view(b, s, d)

    def _moe(self, h, i):
        m, w = self.m, self.w
        moe = m["moe"]
        e, k = moe["num_experts"], moe["top_k"]
        t, d = h.shape
        pre = f"blocks.{i}.mlp."
        probs = torch.softmax(self._mm(h, w[pre + "router"]), dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :k], top_e[:, :k]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = int(math.ceil(t * k / e * moe["capacity_factor"]))
        e_flat = top_e.reshape(-1)  # token-major, choice-minor
        onehot = F.one_hot(e_flat, e)
        slot = (torch.cumsum(onehot, 0) - onehot).gather(1, e_flat[:, None])[:, 0]
        keep = slot < cap
        f_e = F.one_hot(top_e[:, 0], e).float().mean(0)
        aux = e * torch.sum(f_e * probs.mean(0)) * moe["aux_loss_weight"]
        tok = torch.arange(t, device=h.device).repeat_interleave(k)
        weight = top_p.reshape(-1)
        out = torch.zeros_like(h)
        for x in range(e):
            sel = torch.nonzero((e_flat == x) & keep)[:, 0]
            rows = tok[sel]
            hx = h[rows]
            a = F.silu(self._mm(hx, w[pre + "w1"][x])) * self._mm(hx, w[pre + "w3"][x])
            y = self._mm(a, w[pre + "w2"][x]) * weight[sel][:, None]
            out = out.index_add(0, rows, y)
        return out, aux

    def _layer(self, x, i: int):
        x = x + self._attention(self._rms(x, self.w[f"blocks.{i}.ln1"]), i)
        b, s, d = x.shape
        y, aux = self._moe(self._rms(x, self.w[f"blocks.{i}.ln2"]).reshape(b * s, d), i)
        return x + y.view(b, s, d), aux

    def loss(self, inputs: torch.Tensor, labels: torch.Tensor):
        """(loss, cross-entropy, aux) of one microbatch (B, S)."""
        x = self.w["embed"][inputs]
        aux = torch.zeros((), device=x.device)
        for i in range(self.m["num_layers"]):
            x, a = checkpoint(self._layer, x, i, use_reentrant=False)
            aux = aux + a
        x = self._rms(x, self.w["final_norm"])
        logits = self._mm(x.reshape(-1, x.shape[-1]), self.w["embed"].T)
        ce = (torch.logsumexp(logits, -1) - logits.gather(1, labels.reshape(-1, 1))[:, 0]).mean()
        return ce + aux, ce, aux

    # --------------------------------------------------------------- step
    def _lr(self, step: int) -> float:
        o = self.opt
        warm = min(1.0, (step + 1.0) / max(1.0, o["warmup_steps"]))
        frac = min(1.0, max(0.0, (step - o["warmup_steps"])
                            / max(1.0, o["total_steps"] - o["warmup_steps"])))
        decay = o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * 0.5 * (1.0 + math.cos(math.pi * frac))
        return o["learning_rate"] * warm * decay

    def step(self, inputs: torch.Tensor, labels: torch.Tensor, micro: int):
        """One training step; returns (loss, {leaf: the clipped gradient's
        norm}) — the gradient as the optimizer takes it."""
        for p in self.w.values():
            p.grad = None
        size = inputs.shape[0] // micro
        total = 0.0
        for j in range(micro):
            loss, _, _ = self.loss(inputs[j * size:(j + 1) * size], labels[j * size:(j + 1) * size])
            (loss / micro).backward()
            total += float(loss.detach()) / micro
        o = self.opt
        with torch.no_grad():
            grads = {k: p.grad for k, p in self.w.items()}
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
            t = self.steps + 1
            bc1, bc2 = 1.0 - o["beta1"] ** t, 1.0 - o["beta2"] ** t
            lr = self._lr(self.steps)
            norms = {}
            for name, p in self.w.items():
                g = grads[name] * scale
                norms[name] = float(torch.linalg.vector_norm(g))
                self.mom[name].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
                self.vel[name].mul_(o["beta2"]).add_(g * g, alpha=1 - o["beta2"])
                upd = (self.mom[name] / bc1) / (torch.sqrt(self.vel[name] / bc2) + o["eps"])
                p.sub_(lr * (upd + o["weight_decay"] * p))
        self.steps += 1
        return total, norms


def leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves: List[str]) -> tuple:
    """Widest gap between two per-leaf norms, each over the larger of the
    reference leaf's norm and the median leaf's: (gap, leaf)."""
    med = sorted(want[k] for k in leaves)[len(leaves) // 2]
    worst, at = 0.0, None
    for k in leaves:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at
